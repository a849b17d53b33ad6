"""The runs of the mesh tests (``tests/test_torch_mesh*.py``), shared by the
ranks that ``spmd.spawn`` starts and by the test process, which runs each
case unsharded.  This module imports the port only: the spawned ranks load
it by name, and no JAX comes with it.

Every case is a small logistic regression (``make_problem``: d = 10, 96
samples over the m nodes) on the reference's hyper-parameters
(``tests/test_runner_shard.py``, ``tests/test_transport.py``).
"""

import numpy as np
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, gossip, graphs, inexact, prox, \
    runner, spmd, sweep, transport
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
from repro_torch.scenarios import matrix, transports as sc_transports

D, N = 10, 96
WORLD = 4


def loss(w, batch):
    logits = batch["features"] @ w
    return torch.mean(-batch["labels"] * logits
                      + torch.log1p(torch.exp(logits)))


def parts(m: int) -> dict:
    ds = synthetic.make_classification(n=N, d=D, seed=0)
    return synthetic.partition_per_node(ds, m)


def make_problem(m: int, lam: float = 0.01) -> algorithm.Problem:
    return algorithm.Problem(loss, prox.l1(lam), torch.zeros(m, D),
                             params_from_numpy(parts(m), "cpu"))


def schedule(pkg, name: str, m: int):
    """A schedule of ``pkg`` (the port's or the reference's graphs)."""
    if name == "matching":
        mats = pkg.edge_matching_matrices(m)
        return pkg.MixingSchedule(tuple(mats), b=len(mats), eta=0.5,
                                  name=f"matching{m}")
    if name == "centralized":
        return pkg.static_schedule(np.eye(1), name="centralized")
    b = int(name[len("ring"):] or 1)
    return pkg.b_connected_ring_schedule(m, b=b, seed=0)


def factory(alg, name: str, problem, inexact_mod=None):
    """The algorithm ``name`` of package module ``alg`` (the port's or the
    reference's ``algorithm``) on ``problem``."""
    if name == "dpsvrg":
        return alg.dpsvrg_algorithm(problem, alg.DPSVRGHyperParams(
            alpha=0.3, beta=1.2, n0=3, num_outer=3, k_max=2))
    if name == "dpsvrg4":
        return alg.dpsvrg_algorithm(problem, alg.DPSVRGHyperParams(
            alpha=0.3, beta=1.2, n0=3, num_outer=4, k_max=2))
    if name == "dspg":
        return alg.dspg_algorithm(problem, alg.DSPGHyperParams(alpha0=0.3),
                                  24)
    if name == "dspg18":
        return alg.dspg_algorithm(problem, alg.DSPGHyperParams(alpha0=0.3),
                                  18)
    if name == "dpg":
        return alg.dpg_algorithm(problem, 0.3, 18)
    if name == "gt_svrg":
        return alg.gt_svrg_algorithm(problem, 0.1, 3, 6)
    if name == "loopless_dpsvrg":
        return alg.loopless_dpsvrg_algorithm(problem, 0.3, 18,
                                             snapshot_prob=0.1)
    if name == "loopless12":
        return alg.loopless_dpsvrg_algorithm(problem, 0.3, 12,
                                             snapshot_prob=0.1)
    if name == "dvr":
        return alg.dvr_algorithm(problem, 0.3, 18, rho=0.7,
                                 snapshot_prob=0.1)
    if name == "inexact_prox_svrg":
        hp = inexact_mod.InexactHyperParams(alpha=0.3, beta=1.2, n0=3,
                                            num_outer=3)
        return alg.ALGORITHMS[name](problem, hp)
    raise KeyError(name)


# ---------------------------------------------------------------------------
# node-sharded runs: one node a rank (ppermute) or m / 4 rows a rank
# ---------------------------------------------------------------------------

# name -> (m, schedule, algorithm, seed, record_every, the sharded spec,
#          the spec of the unsharded run it is held to)
NODE_CASES = {
    "ppermute_dpsvrg_host": (4, "matching", "dpsvrg4", 1, 3,
                             dict(gossip="ppermute"), dict(gossip="dense")),
    "ppermute_dpsvrg_scan": (4, "matching", "dpsvrg4", 1, 3,
                             dict(gossip="ppermute", scan=True),
                             dict(gossip="dense")),
    "ppermute_dspg_matching": (4, "matching", "dspg", 2, 6,
                               dict(gossip="ppermute"),
                               dict(gossip="dense")),
    "ppermute_dspg_ring": (4, "ring", "dspg", 3, 6, dict(gossip="ppermute"),
                           dict(gossip="dense")),
    "ppermute_resident_host_sampling": (
        4, "matching", "dspg", 4, 6, dict(gossip="ppermute", resident=True),
        dict(gossip="dense", resident=True)),
    "ppermute_resident_device_sampling": (
        4, "matching", "dspg", 4, 6,
        dict(gossip="ppermute", resident=True, sampling="device"),
        dict(gossip="dense", resident=True, sampling="device")),
    "nodes_dense": (4, "ring", "loopless_dpsvrg", 0, 4,
                    dict(gossip="dense", resident=True, shard="nodes"),
                    dict(gossip="dense", resident=True)),
    "nodes_ppermute": (4, "ring", "dspg", 1, 6,
                       dict(gossip="ppermute", resident=True,
                            shard="nodes"),
                       dict(gossip="dense", resident=True)),
    "nodes_dense_m8": (8, "ring", "dpsvrg4", 5, 3,
                       dict(gossip="dense", resident=True, shard="nodes"),
                       dict(gossip="dense", resident=True)),
    "nodes_banded_m8": (8, "ring", "dpsvrg4", 5, 3,
                        dict(gossip="banded", resident=True, shard="nodes"),
                        dict(gossip="banded", resident=True)),
    "nodes_compressed_ppermute": (
        4, "ring", "loopless12", 2, 4,
        dict(gossip=("compressed", "ppermute", 4), resident=True,
             shard="nodes"),
        dict(gossip=("compressed", "dense", 4), resident=True)),
    "nodes_compressed_ppermute_int8": (
        4, "ring", "loopless12", 2, 4,
        dict(gossip=("compressed", "ppermute", 8), resident=True,
             shard="nodes"),
        dict(gossip=("compressed", "banded", 8), resident=True)),
    "nodes_compressed_dense_m8": (
        8, "ring", "loopless12", 2, 4,
        dict(gossip=("compressed", "dense", 8), resident=True,
             shard="nodes"),
        dict(gossip=("compressed", "dense", 8), resident=True)),
    "kernel_fused_ppermute": (
        4, "ring", "dpsvrg4", 6, 3,
        dict(gossip="ppermute", resident=True, kernel="fused"),
        dict(gossip="dense", resident=True)),
    "kernel_fused_banded_m8": (
        8, "ring", "dvr", 6, 6,
        dict(gossip="banded", resident=True, shard="nodes", kernel="fused"),
        dict(gossip="banded", resident=True)),
    "kernel_fused_dspg_ppermute": (
        4, "ring", "dspg", 5, 6,
        dict(gossip="ppermute", resident=True, kernel="fused"),
        dict(gossip="dense", resident=True)),
    "kernel_fused_dpg_banded_m8": (
        8, "ring", "dpg", 5, 6,
        dict(gossip="banded", resident=True, shard="nodes", kernel="fused"),
        dict(gossip="banded", resident=True)),
    "scenario_ppermute": (
        4, "ring", "loopless12", 7, 4,
        dict(gossip=("scenario", "ppermute", 1), resident=True),
        dict(gossip=("scenario", "banded", 1), resident=True)),
}


def gossip_spec(g):
    """A case's ``gossip`` field: a name, or a tuple naming a wrapping
    transport (``("compressed", inner, bits)``, ``("scenario", inner,
    delay)``)."""
    if not isinstance(g, tuple):
        return g
    kind, inner, arg = g
    if kind == "compressed":
        return transport.CompressedBackend(inner=inner, bits=arg)
    return sc_transports.ScenarioBackend(inner=inner, delay=arg)


def run_node_case(name: str, sharded: bool, device="cpu"):
    """Case ``name``'s run on this rank (``sharded``: the rank's rows of
    the problem) or on the whole stack."""
    m, sched, algo, seed, every, kw, plain_kw = NODE_CASES[name]
    kw = dict(kw if sharded else plain_kw)
    kw["gossip"] = gossip_spec(kw["gossip"])
    problem = make_problem(m)
    problem = problem._replace(
        x0=problem.x0.to(device),
        full_data=torch.utils._pytree.tree_map(lambda a: a.to(device),
                                               problem.full_data))
    if sharded:
        problem = spmd.local_problem(problem)
    return runner.run(factory(algorithm, algo, problem), problem,
                      schedule(graphs, sched, m),
                      ExecSpec(device=device, **kw), seed=seed,
                      record_every=every)


def _summary(res) -> dict:
    return {"history": res.history._asdict(), "params": res.params,
            "extras": {k: v for k, v in res.extras.items()}}


def node_cases() -> dict:
    """Every node-sharded case on this rank, the wire accounting of the
    compressed ppermute transport, and what ``"auto"`` picks."""
    out = {name: _summary(run_node_case(name, True)) for name in NODE_CASES}
    problem = make_problem(4)
    ring = schedule(graphs, "ring", 4)
    matching = schedule(graphs, "matching", 4)
    mesh = spmd.world_mesh("nodes")
    meta = factory(algorithm, "dspg", spmd.local_problem(problem)).meta
    out["auto"] = {"with_mesh": transport.select_backend_name(matching, meta,
                                                              mesh),
                   "without_mesh": transport.select_backend_name(matching,
                                                                 meta)}
    # the per-link map sums exactly to bytes_per_step, also at bits that
    # do not divide 32
    pc = transport.node_param_count(problem.x0)
    lmeta = factory(algorithm, "loopless12", problem).meta
    exact = {}
    for bits in (4, 3):
        be = transport.CompressedBackend(inner="ppermute", bits=bits)
        aux = be.prepare(ring, lmeta, mesh=None)
        ok = True
        for slot in range(lmeta.slot_start, lmeta.slot_start + 3):
            phi = be.phi_for(aux, slot, 2)
            ok = ok and (sum(be.bytes_per_link(aux, phi, pc).values())
                         == be.bytes_per_step(aux, phi, pc))
        exact[bits] = ok
    out["link_sums_exact"] = exact
    out["errors"] = refusals()
    return out


def _message(fn) -> "str | None":
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def refusals() -> dict:
    """The messages of what a group of ranks refuses (None: no refusal)."""
    ring4 = schedule(graphs, "ring", 4)
    whole = make_problem(4)
    local = spmd.local_problem(whole)

    def run(problem, algo, sched, **kw):
        return runner.run(factory(algorithm, algo, problem), problem, sched,
                          ExecSpec(device="cpu", **kw), record_every=6)

    three = make_problem(3)
    return {
        "nodes_divisibility": _message(lambda: run(
            three, "dspg", schedule(graphs, "ring", 3), resident=True,
            gossip="dense", shard="nodes")),
        "ppermute_world": _message(lambda: run(
            make_problem(8), "dspg", schedule(graphs, "ring", 8),
            gossip="ppermute")),
        "whole_problem": _message(lambda: run(whole, "dspg", ring4,
                                              gossip="ppermute")),
        "cells_divisibility": _message(lambda: sweep.run_sweep(
            lambda: (factory(algorithm, "loopless_dpsvrg", whole), whole),
            {"seed": [0, 1, 2]}, ring4,
            ExecSpec(resident=True, gossip="dense", shard="cells",
                     device="cpu"))),
        "batched_ppermute": _message(lambda: sweep.run_sweep(
            lambda: (factory(algorithm, "dspg", local), local),
            {"seed": [0, 1]}, ring4,
            ExecSpec(resident=True, gossip="ppermute", device="cpu"))),
        "fused_sgd": _message(lambda: run(
            spmd.local_problem(algorithm.Problem(
                loss, prox.squared_l2(0.01), whole.x0, whole.full_data)),
            "dspg", ring4, resident=True, gossip="ppermute",
            kernel="fused")),
        "fused_compressed": _message(lambda: run(
            local, "loopless12", ring4, resident=True, kernel="fused",
            gossip=transport.CompressedBackend(inner="ppermute", bits=8))),
    }


# ---------------------------------------------------------------------------
# cell-sharded sweeps: one cell a rank
# ---------------------------------------------------------------------------

CELL_ALGORITHMS = ["dpsvrg", "dspg18", "dpg", "gt_svrg", "loopless_dpsvrg",
                   "dvr", "inexact_prox_svrg"]
CELL_GRID = {"seed": [0, 1, 2, 3]}


def cell_build(name: str):
    """The sweep's ``(cell factory, schedule)`` for ``name`` (m = 4 on the
    b = 1 ring; Algorithm 2 on one node)."""
    m = 1 if name == "inexact_prox_svrg" else 4
    problem = make_problem(m)
    sched = schedule(graphs, "centralized" if m == 1 else "ring", m)

    def build():
        return factory(algorithm, name, problem, inexact), problem

    return build, sched


def topology_scheds(pkg) -> list:
    return [pkg.b_connected_ring_schedule(4, b=b, seed=b)
            for b in (1, 2, 1, 3)]


def run_topology_grid(mesh=None):
    problem = make_problem(4)

    def build():
        return factory(algorithm, "loopless_dpsvrg", problem), problem

    spec = ExecSpec(resident=True, gossip="dense", device="cpu")
    if mesh is not None:
        spec = spec.replace(mesh=mesh, shard="cells")
    return sweep.run_sweep(build, {"schedule": topology_scheds(graphs),
                                   "seed": [0, 1, 2, 3]},
                           exec=spec, record_every=4, mode="zip")


def matrix_inputs():
    """run_matrix's inputs: two topologies, a failure-free and a stale
    scenario, DSPG and loopless DPSVRG, f32 and int8, two seeds."""
    from repro_torch import scenarios
    problem = make_problem(4)
    topologies = {"ring": schedule(graphs, "ring", 4),
                  "ring2": schedule(graphs, "ring2", 4)}
    failures = {"none": [], "links": [scenarios.LinkFailures(0.2)]}
    algorithms = {"loopless": lambda p: factory(algorithm,
                                                "loopless_dpsvrg", p)}
    return problem, topologies, failures, algorithms


def run_matrix(shard=None):
    problem, topologies, failures, algorithms = matrix_inputs()
    res = matrix.run_matrix(problem, topologies, failures, algorithms,
                            compressions=(None, 8), seeds=(0, 1),
                            record_every=6, shard=shard, device="cpu")
    return [tuple(r) for r in res.rows], \
        [(g["transfers_h2d"], g["transfers_d2h"]) for g in res.groups]


def cell_cases() -> dict:
    out = {}
    for name in CELL_ALGORITHMS:
        build, sched = cell_build(name)
        res = sweep.run_sweep(build, CELL_GRID, sched,
                              ExecSpec(resident=True, gossip="dense",
                                       shard="cells", device="cpu"),
                              record_every=4)
        out[name] = _summary(res)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("cells",))
    out["topology"] = _summary(run_topology_grid(mesh))
    out["matrix"] = run_matrix("cells")
    return out


# ---------------------------------------------------------------------------
# spawn's failure handling
# ---------------------------------------------------------------------------

def fail_on_rank(bad: int) -> int:
    """Rank ``bad`` raises; the others wait for it in a barrier."""
    if spmd.dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} gives up")
    spmd.dist.barrier()
    return spmd.dist.get_rank()


def sleep_for(seconds: float) -> None:
    import time
    time.sleep(seconds)


# ---------------------------------------------------------------------------
# The LM path across ranks (tests/test_torch_mesh_lm.py)
# ---------------------------------------------------------------------------

# test_eight_device_equivalence's toy config
TINY_LM = dict(name="tiny", arch_type="dense", num_layers=2, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
               scan_layers=False)
LM_ARCHS = ("tiny", "h2o-danube-1.8b", "llama4-scout-17b-a16e")
LM_LAM, LM_ALPHA = 1e-4, 0.1
LM_TOKENS = np.random.default_rng(7).integers(0, 64, size=2400)


def lm_cfg(arch: str, serve: bool = False):
    """The port's config of ``arch`` at its smoke size (``TINY_LM`` for
    ``"tiny"``); trained without the kernels, served with them."""
    from repro_torch import configs
    from repro_torch.models.api import ModelConfig
    if arch == "tiny":
        return ModelConfig(**TINY_LM)
    cfg = configs.smoke_variant(configs.get_config(arch))
    return cfg if serve else cfg.scaled(use_flash=False,
                                        use_fused_norm=False)


def lm_inputs(vocab: int, m: int, seed: int = 0) -> dict:
    """The batch (also the snapshot's large batch, as in the reference's
    test) and the two steps' dense mixing matrices on the b=2 ring."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(m, 2, 16)).astype(np.int64)
    sched = graphs.b_connected_ring_schedule(m, b=2, seed=0)
    return {"batch": {"tokens": toks, "labels": toks},
            "phis": [sched.consensus_rounds(0, 2).astype(np.float32),
                     sched.consensus_rounds(2, 2).astype(np.float32)]}


def lm_phi(phi: np.ndarray, kind: str, device="cpu", layout=None):
    """``phi`` dense, as its bands, or as its bands exchanged point to point
    over ``layout``'s node axis (``"ppermute"``, one node a rank), on
    ``device``."""
    if kind == "dense":
        return torch.as_tensor(phi, device=device)
    offsets, _ = gossip.band_decompose(phi)
    coeffs = torch.as_tensor(gossip.bands_for_phi(phi, offsets),
                             device=device)
    if kind == "ppermute":
        return gossip.PermutePhi(offsets, layout.node_mesh, layout.axis.axis,
                                 coeffs)
    return gossip.BandedPhi(offsets, coeffs)


def lm_train_steps(cfg, init, m: int, phi_kind: str, device="cpu",
                   plan=None, mesh=None) -> dict:
    """A snapshot refresh and two DPSVRG steps from the whole stacked
    ``init`` (numpy, every node alike): the whole stacked params after
    them, and each step's loss and v_norm."""
    from repro_torch.train import steps
    bundle = steps.build_train_step(cfg, prox.l1(LM_LAM), m, plan=plan,
                                    mesh=mesh)
    params = params_from_numpy(init, device)
    stacked = torch.utils._pytree.tree_map(
        lambda x: x[None].expand((m,) + x.shape).clone(), params)
    zeros = torch.utils._pytree.tree_map(torch.zeros_like, stacked)
    placed = bundle.place(stacked)
    state = steps.TrainState(
        params=placed, snapshot=placed, full_grad=bundle.place(zeros),
        step=torch.zeros((), dtype=torch.int32, device=device))
    inputs = lm_inputs(cfg.vocab_size, m)
    batch = params_from_numpy(inputs["batch"], device)
    state = bundle.snapshot_step(state, batch)
    layout = None if mesh is None else steps.node_layout(mesh, plan, m)
    metrics = []
    for phi in inputs["phis"]:
        state, mets = bundle.train_step(
            state, batch, lm_phi(phi, phi_kind, device, layout), LM_ALPHA)
        metrics.append([float(mets["loss"]), float(mets["v_norm"])])
    return {"params": bundle.gather(state.params),
            "metrics": np.asarray(metrics)}


def lm_modality(cfg, batch: int = 2) -> dict:
    """The stub modality inputs a config's prefill takes (numpy): audio
    frames for an encoder, image rows for a vision prefix, else none."""
    from repro_torch.models import multimodal
    out = {}
    if cfg.encoder_layers:
        out["audio_frames"] = multimodal.fake_audio_frames(
            batch, cfg.d_model, frames=cfg.encoder_seq, seed=5)
    if cfg.frontend == "vision_stub":
        out["image_embeds"] = multimodal.fake_image_patches(
            batch, cfg.d_model, tokens=cfg.image_tokens, seed=5)
    return out


def lm_serve(cfg, params, device="cpu", plan=None, mesh=None,
             decode: int = 2) -> dict:
    """Prefill 2 prompts of 8 tokens (after the config's stub modality
    inputs), then ``decode`` greedy steps: the tokens and each step's
    logits, whole."""
    from repro_torch.train import steps
    bundle = steps.build_serve_steps(cfg, plan=plan, mesh=mesh)
    p = bundle.place_params(params_from_numpy(params, device))
    prompts = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 8)), device=device)
    whole = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x
    modality = {k: torch.as_tensor(v, device=device)
                for k, v in lm_modality(cfg).items()}
    prefix = modality["image_embeds"].shape[1] \
        if "image_embeds" in modality else 0
    logits, cache = bundle.prefill_step(p, prompts,
                                        max_len=prefix + 8 + decode,
                                        **modality)
    outs, toks = [whole(logits)], []
    for _ in range(decode):
        tok = torch.argmax(outs[-1], dim=-1)
        toks.append(tok)
        logits, cache = bundle.decode_step(p, cache, tok)
        outs.append(whole(logits))
    return {"tokens": torch.stack(toks, dim=1), "logits": torch.stack(outs)}


def lm_loader(m: int):
    from repro_torch.data.loader import LMLoader
    return LMLoader(LM_TOKENS, num_nodes=m, per_node_batch=2, seq_len=16,
                    seed=1)


def lm_trainer_config(**kw):
    from repro_torch.train import trainer
    base = dict(num_steps=3, snapshot_every=2, log_every=1, alpha=0.05,
                consensus_rounds=2, seed=0, gossip="dense")
    base.update(kw)
    return trainer.TrainerConfig(**base)


def lm_train_loop(m: int, device="cpu", plan=None, mesh=None,
                  resume: bool = False, **config) -> dict:
    """``train_loop`` of the tiny config on the host loop (``config``
    overriding ``lm_trainer_config``'s): its history, wire bytes and the
    whole final state."""
    from repro_torch.train import steps, trainer
    cfg = lm_cfg("tiny")
    hist = trainer.train_loop(
        cfg, prox.l1(LM_LAM), graphs.b_connected_ring_schedule(m, b=2,
                                                               seed=0),
        lm_loader(m), lm_trainer_config(**config), mesh=mesh, plan=plan,
        exec=ExecSpec(device=device), resume=resume)
    state = hist["final_state"]
    if mesh is not None:
        bundle = steps.build_train_step(cfg, prox.l1(LM_LAM), m, plan=plan,
                                        mesh=mesh)
        state = state._replace(params=bundle.gather(state.params),
                               snapshot=bundle.gather(state.snapshot),
                               full_grad=bundle.gather(state.full_grad),
                               mix_state=None)
    return {"loss": np.asarray(hist["loss"]),
            "v_norm": np.asarray(hist["v_norm"]),
            "wire_bytes": np.asarray(hist["wire_bytes"]),
            "step": np.asarray(hist["step"]),
            "params": state.params, "state": state,
            "wire": hist.get("wire")}


LM_SWEEP_GRID = {"lam": [1e-4, 1e-3]}


def lm_train_sweep(init, m: int = 4, device="cpu", mesh=None) -> dict:
    """``train_sweep`` of two l1 cells of a 1-layer toy model from the
    whole ``init`` (numpy), split over the mesh's ``"cells"`` dim when
    ``mesh`` is given."""
    from repro_torch.models.api import ModelConfig
    from repro_torch.train import steps, trainer
    cfg = ModelConfig(**dict(TINY_LM, name="tiny-sw", num_layers=1,
                             num_heads=2, num_kv_heads=1))
    real = steps.transformer.init_params
    steps.transformer.init_params = \
        lambda cfg_, seed, device=device: params_from_numpy(init, device)
    try:
        out = trainer.train_sweep(
            cfg, prox.l1, graphs.b_connected_ring_schedule(m, b=2, seed=0),
            lm_loader(m), lm_trainer_config(num_steps=5, snapshot_every=3,
                                            log_every=2, gossip="auto"),
            LM_SWEEP_GRID, exec=ExecSpec(
                resident=True, device=device,
                shard=None if mesh is None else "cells", mesh=mesh))
    finally:
        steps.transformer.init_params = real
    return {k: out[k] for k in ("loss", "v_norm", "alpha", "wire_bytes",
                                "step")} | {
        "params": out["final_state"].params, "wire": out.get("wire")}


def lm_meshes(device="cpu") -> dict:
    """The faithful (data=2, model=2) mesh with m = 4 and the production
    (pod=2, data=2, model=1) one with m = 2, FSDP over data."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import sharding
    return {
        "faithful": (mesh_lib.make_mesh((2, 2), ("data", "model"), device),
                     mesh_lib.PLANS[("single", "faithful")], 4),
        "production": (mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                          device),
                       sharding.MeshPlan(node_axes=("pod",),
                                         fsdp_axes=("data",),
                                         fsdp_min_size=0), 2),
    }


def lm_cases(inits: dict, sweep_init, device="cpu") -> dict:
    """Every sharded LM case of one group of 4 ranks: the train steps of
    each arch on the faithful mesh (dense phi; the tiny config banded too)
    and of the tiny config on the production mesh, sharded serving on the
    faithful mesh, ``train_loop`` on it, and ``train_sweep`` split over a
    ``("cells", "other")`` mesh."""
    from repro_torch.launch import mesh as mesh_lib
    meshes = lm_meshes(device)
    out = {}
    mesh, plan, m = meshes["faithful"]
    for arch in LM_ARCHS:
        kinds = ("dense", "banded") if arch == "tiny" else ("dense",)
        for kind in kinds:
            out[f"faithful/{arch}/{kind}"] = lm_train_steps(
                lm_cfg(arch), inits[arch], m, kind, device, plan, mesh)
    pmesh, pplan, pm = meshes["production"]
    for kind in ("dense", "banded"):
        out[f"production/tiny/{kind}"] = lm_train_steps(
            lm_cfg("tiny"), inits["tiny"], pm, kind, device, pplan, pmesh)
    out["serve"] = lm_serve(lm_cfg("h2o-danube-1.8b", serve=True),
                            inits["h2o-danube-1.8b"], device, plan, mesh)
    out["train_loop"] = lm_train_loop(m, device, plan, mesh)
    cells = mesh_lib.make_mesh((2, 2), ("cells", "other"), device)
    out["train_sweep"] = lm_train_sweep(sweep_init, device=device, mesh=cells)
    if device == "cpu":
        # the host-staged route of the placed tensors' collectives, which
        # ranks sharing a card take, on the CPU last
        spmd.stage_placed_collectives("cpu")
        out["staged/tiny/dense"] = lm_train_steps(
            lm_cfg("tiny"), inits["tiny"], m, "dense", device, plan, mesh)
    return out


def card_mesh_cases(init) -> dict:
    """Two ranks sharing one card over gloo (host-staged): a node-sharded
    run (``shard="nodes"``, the tests' first one) and a sharded train step
    of the toy LM on a (data=1, model=2) mesh with m = 2 (each leaf split
    over model, its collectives host-staged)."""
    from repro_torch.launch import mesh as mesh_lib
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"), "cuda")
    return {"nodes": _summary(run_node_case("nodes_dense", True, "cuda")),
            "lm": lm_train_steps(lm_cfg("tiny"), init, 2, "dense", "cuda",
                                 mesh_lib.PLANS[("single", "faithful")],
                                 mesh),
            "wire": spmd.placed_wire(mesh)}


# ---------------------------------------------------------------------------
# The zoo across ranks (tests/test_torch_mesh_zoo.py)
# ---------------------------------------------------------------------------

def zoo_archs() -> tuple:
    """Every LM arch of ``configs`` (all but the logistic regression)."""
    from repro_torch import configs
    return tuple(a for a in configs.list_archs() if a != "paper_logreg")


def zoo_trained(arch: str) -> bool:
    """Whether ``arch`` trains on tokens alone (no stub modality input)."""
    return not lm_modality(lm_cfg(arch))


ZOO_M = 2


def zoo_mesh(device="cpu"):
    """The faithful (data=2, model=2) mesh: m = 2, a node a data rank,
    each leaf split over model."""
    from repro_torch.launch import mesh as mesh_lib
    return (mesh_lib.make_mesh((2, 2), ("data", "model"), device),
            mesh_lib.PLANS[("single", "faithful")])


# the two mixers that run on each rank's channels, their config's spec and
# the name of the weight whose columns are two halves split in place
ZOO_MIXERS = {"mamba": ("jamba-1.5-large-398b", "in_proj"),
              "mlstm": ("xlstm-350m", "up_proj")}


def mixer_spec(kind: str):
    from repro_torch.models.api import layer_plan
    arch, _ = ZOO_MIXERS[kind]
    return next(getattr(p, kind) for p in layer_plan(lm_cfg(arch))
                if p.mixer == kind)


def mixer_inputs(kind: str, d: int, batch: int = 2, length: int = 6,
                 seed: int = 11):
    """Numpy weights of one ``kind`` mixer (the port's init at ``seed``),
    an input (batch, length, d), one decode token's input and a cotangent
    of the output."""
    from repro_torch.models import common, ssm
    spec = mixer_spec(kind)
    init = {"mamba": ssm.init_mamba, "mlstm": ssm.init_mlstm}[kind]
    params = init(common.make_generator(seed, "cpu"), spec)
    rng = np.random.default_rng(seed)
    return {"params": {k: v.numpy() for k, v in params.items()},
            "x": rng.normal(size=(batch, length, d)).astype(np.float32),
            "x_t": rng.normal(size=(batch, 1, d)).astype(np.float32),
            "cot": rng.normal(size=(batch, length, d)).astype(np.float32)}


def mixer_run(kind: str, inputs: dict, device="cpu", plan=None,
              mesh=None) -> dict:
    """One mixer on ``inputs``: its forward, the gradient of <forward,
    cot> by every weight and by the input, a prefill's state and one
    decode step from it, and the two halves of its up-projection's product
    as the rank's channels regroup them (whole); placed by ``plan``'s
    specs on ``mesh`` (the cache by ``cache_specs``, the batch over
    "data") when given, else on one device."""
    from repro_torch.models import placed, ssm, transformer
    from repro_torch.train import sharding
    spec = mixer_spec(kind)
    fns = {"mamba": (ssm.mamba_forward, transformer._mamba_prefill,
                     ssm.mamba_step),
           "mlstm": (ssm.mlstm_forward, transformer._mlstm_prefill,
                     ssm.mlstm_step)}[kind]
    unit = spec.head_dim if kind == "mlstm" else 1
    params = params_from_numpy(inputs["params"], device)
    x, x_t, cot = (torch.as_tensor(inputs[k], device=device)
                   for k in ("x", "x_t", "cot"))
    whole = lambda t: t.full_tensor() if placed.is_placed(t) else t  # noqa
    if mesh is not None:
        spmd.placed_wire(mesh)    # host-staged where ranks share a card
        sizes = spmd.mesh_shape(mesh)
        pspecs = sharding.param_specs(params, plan, axis_sizes=sizes)
        params = {k: sharding.place(v, mesh, sharding.placements(
            pspecs[k], mesh)) for k, v in params.items()}
        split = lambda t: sharding.place(t, mesh, sharding.placements(  # noqa
            ("data",) + (None,) * (t.ndim - 1), mesh))
        x, x_t = split(x), split(x_t)
    for t in list(params.values()) + [x]:
        t.requires_grad_(True)

    def call(fn, *args):
        return placed.channel_call(fn, kind, params, spec, *args, unit=unit)

    out = call(fns[0], x)
    leaves = dict(params, x=x)
    grads = torch.autograd.grad((whole(out) * cot).sum(),
                                list(leaves.values()))
    with torch.no_grad():
        _, state = call(fns[1], x)
        if mesh is not None:
            cspecs = sharding.cache_specs(state, plan, axis_sizes=sizes)
            state = {k: v.redistribute(mesh, sharding.placements(
                cspecs[k], mesh)) for k, v in state.items()}
        step, new_state = call(fns[2], x_t, state)
        up = ZOO_MIXERS[kind][1]

        def half(which):
            def probe(p, spec_, x_, ch):
                return torch.zeros_like(x_), {
                    "conv": ch.halves(x_ @ p[up])[which]}
            return whole(call(probe, x)[1]["conv"])

        halves = [half(0), half(1)] if mesh is not None else list(
            torch.chunk(x @ params[up], 2, dim=-1))
    return {"out": whole(out).detach(),
            "grads": {k: whole(g) for k, g in zip(leaves, grads)},
            "state": {k: whole(v) for k, v in state.items()},
            "step": whole(step), "new_state": {
                k: whole(v) for k, v in new_state.items()},
            "halves": halves}


def regions_of(fn):
    """``fn()`` and the mixers that ran through ``placed.channel_call`` and
    ``placed.replicated_call`` in it, in call order."""
    from repro_torch.models import placed
    seen = {"channel_call": [], "replicated_call": []}
    real = {name: getattr(placed, name) for name in seen}

    def recording(name):
        def call(body, *args, **kw):
            seen[name].append(next(k for k in ("mamba", "mlstm", "slstm")
                                   if k in body.__name__))
            return real[name](body, *args, **kw)
        return call

    try:
        for name in seen:
            setattr(placed, name, recording(name))
        return fn(), seen
    finally:
        for name, f in real.items():
            setattr(placed, name, f)


def zoo_cases(inits: dict, mixers: dict, device="cpu") -> dict:
    """Every case of the zoo across one group of 4 ranks: each arch's
    smoke variant served (2 requests, a prefill and 2 greedy steps) and
    each token-path arch trained (a refresh and 2 DPSVRG steps, m = 2) on
    the faithful (data=2, model=2) mesh, and each channel-split mixer on
    it (model=2) and on a (data=1, model=4) mesh."""
    from repro_torch.launch import mesh as mesh_lib
    mesh, plan = zoo_mesh(device)
    out = {"regions": {}}
    for arch in zoo_archs():
        serve = lambda: lm_serve(lm_cfg(arch, serve=True),  # noqa
                                 inits[arch], device, plan, mesh)
        if arch in ("jamba-1.5-large-398b", "xlstm-350m"):
            out[f"serve/{arch}"], out["regions"][arch] = regions_of(serve)
        else:
            out[f"serve/{arch}"] = serve()
        if zoo_trained(arch):
            out[f"train/{arch}"] = lm_train_steps(
                lm_cfg(arch), inits[arch], ZOO_M, "dense", device, plan,
                mesh)
    wide = mesh_lib.make_mesh((1, 4), ("data", "model"), device)
    for kind, inputs in mixers.items():
        out[f"mixer/{kind}/model2"] = mixer_run(kind, inputs, device, plan,
                                                mesh)
        out[f"mixer/{kind}/model4"] = mixer_run(kind, inputs, device, plan,
                                                wide)
    return out


# ---------------------------------------------------------------------------
# Node axes over two mesh dims, and checkpoints of sharded runs
# (tests/test_torch_mesh_ckpt.py)
# ---------------------------------------------------------------------------

def ckpt_meshes(device="cpu") -> dict:
    """The ("multi", "faithful") plan on (pod=2, data=2, model=1) (the m = 4
    nodes over pod and data, one a rank), the same nodes over one dim
    (data=4, model=1), and the faithful (data=2, model=2) mesh (two nodes
    a rank, each leaf split over model)."""
    from repro_torch.launch import mesh as mesh_lib
    single = mesh_lib.PLANS[("single", "faithful")]
    return {
        "multi": (mesh_lib.make_mesh((2, 2, 1), ("pod", "data", "model"),
                                     device),
                  mesh_lib.PLANS[("multi", "faithful")]),
        "data4": (mesh_lib.make_mesh((4, 1), ("data", "model"), device),
                  single),
        "faithful": (mesh_lib.make_mesh((2, 2), ("data", "model"), device),
                     single),
    }


# the checkpointed runs: a checkpoint every step, the newest 3 kept; a
# crash after step 3 leaves steps 1-3, and the resume runs steps 3 and 4
# (a snapshot refresh at 4)
CKPT_RUN = dict(num_steps=5, ckpt_every=1, keep_last=3)
CKPT_CRASH_AFTER = 3


def crash_copy(src: str, dst: str) -> None:
    """``src``'s checkpoints as a run that crashed after writing step
    ``CKPT_CRASH_AFTER`` left them."""
    import os
    import shutil
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if int(name.split("_")[1]) > CKPT_CRASH_AFTER:
            shutil.rmtree(os.path.join(dst, name))


def _on_rank0(fn, *args) -> None:
    if spmd.dist.get_rank() == 0:
        fn(*args)
    spmd.dist.barrier()


def ckpt_cases(init, root: str, unsharded_dir: str, device="cpu") -> dict:
    """Every case of one group of 4 ranks: the tiny config's train steps
    (dense, banded, ppermute) and ``train_loop`` (dense, ppermute) on the
    two-dim node axis and on one dim; ``train_loop`` with checkpoints on
    the faithful mesh (dense and compressed), resumed on it, and its crash
    resumed on the two-dim node axis; the unsharded run's crash under
    ``unsharded_dir`` resumed on the faithful mesh.  Checkpoints go under
    ``root``; each rank counts its checkpoint writes and prunings."""
    import os

    from repro_torch import checkpoint as ckpt_lib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import steps
    meshes = ckpt_meshes(device)
    out = {}
    tiny = lm_cfg("tiny")
    mesh, plan = meshes["multi"]
    ax = steps.node_layout(mesh, plan, 4).axis
    out["multi_axis"] = {"index": ax.index, "ranks": list(ax.ranks),
                         "rows": [ax.rows.start, ax.rows.stop],
                         "name": ax.axis,
                         "node_count": mesh_lib.node_count(mesh, plan)}
    # the node dims the whole mesh: one flattened dim, no other
    whole = spmd.node_axis(mesh_lib.make_mesh((2, 2), ("pod", "data"),
                                              device), ("pod", "data"), 4)
    out["whole_mesh_axis"] = [whole.index, whole.size, whole.axis]
    for name in ("multi", "data4"):
        mesh, plan = meshes[name]
        for kind in ("dense", "banded", "ppermute"):
            out[f"steps/{name}/{kind}"] = lm_train_steps(
                tiny, init, 4, kind, device, plan, mesh)
        for kind in ("dense", "ppermute"):
            out[f"loop/{name}/{kind}"] = lm_train_loop(
                4, device, plan, mesh, gossip=kind)
    counts = {"save": 0, "prune": 0}
    real = {"save": ckpt_lib.save, "prune": ckpt_lib._prune_old}

    def counting(name):
        def call(*args, **kw):
            counts[name] += 1
            return real[name](*args, **kw)
        return call

    ckpt_lib.save, ckpt_lib._prune_old = counting("save"), counting("prune")
    try:
        mesh, plan = meshes["faithful"]
        for kind in ("dense", "compressed"):
            d = os.path.join(root, kind)
            out[f"ckpt/{kind}"] = lm_train_loop(
                4, device, plan, mesh, gossip=kind, ckpt_dir=d, **CKPT_RUN)
            _on_rank0(crash_copy, d, d + "-crash")
            out[f"resumed/{kind}"] = lm_train_loop(
                4, device, plan, mesh, resume=True, gossip=kind,
                ckpt_dir=d + "-crash", **CKPT_RUN)
        _on_rank0(crash_copy, os.path.join(root, "dense"),
                  os.path.join(root, "to-multi"))
        mesh, plan = meshes["multi"]
        out["resumed/multi"] = lm_train_loop(
            4, device, plan, mesh, resume=True,
            ckpt_dir=os.path.join(root, "to-multi"), **CKPT_RUN)
        mesh, plan = meshes["faithful"]
        out["resumed/from-unsharded"] = lm_train_loop(
            4, device, plan, mesh, resume=True, ckpt_dir=unsharded_dir,
            **CKPT_RUN)
    finally:
        ckpt_lib.save, ckpt_lib._prune_old = real["save"], real["prune"]
    out["writes"] = dict(counts)
    return out
