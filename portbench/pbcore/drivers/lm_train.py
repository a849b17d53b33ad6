"""Decentralized LM training with DPSVRG on one card: the program's
``train.trainer.train_loop`` on its resident path, fed by the program's
``LMLoader`` over token shards made from the seed.

Traffic parameters: ``m``, ``seq``, ``snapshot_every``,
``snapshot_batch_mult``, ``alpha``, ``lam``, ``consensus_rounds``,
``gossip``, ``shard_tokens`` (tokens a node holds), ``checked_steps``,
``trace_rounds`` and ``limits``; the per-node batch is the configuration's
``per_node_batch``.

``train_loop`` starts from a state of its own making or from a checkpoint,
and a checkpoint of this cell's state is ~21 GB.  So the harness hands it
the state as the program's bundle would make it, through the bundle's
``init_state``: the weights made from the seed, stacked once a node.  Set-up
runs ``train_loop`` over the first ``checked_steps`` steps (a refresh and
the steps), whose losses, update norms, first full gradients and parameter
changes the reference follows.  The window hands the same state on to one
``train_loop`` call a round (a refresh and ``snapshot_every`` steps), with
the same loader, to the first round boundary after ``--seconds``;
``train_tokens_per_s`` counts the tokens of the steps' minibatches and the
refreshes' batches over the window's wall time."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..frozen import counts
from ..harness import Outcome
from . import lm_common


def make_tokens(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """The token stream, m shards of ``shard_tokens`` uniform ids."""
    return np.random.default_rng([seed, 0x74]).integers(
        0, vocab, size=mix["m"] * mix["shard_tokens"], dtype=np.int32)


def mix_matrix(m: int, rounds: int) -> np.ndarray:
    from reference.logreg_dpsvrg import ring_matrix
    w = np.eye(m)
    for _ in range(rounds):
        w = ring_matrix(m) @ w
    return w


@contextlib.contextmanager
def starting_from(held: list):
    """Within, every train bundle the program builds starts from the state
    in ``held`` (taken out, so that the caller keeps no reference to it)."""
    from repro_torch.train import steps

    real = steps.build_train_step

    def build(*a, **k):
        bundle = real(*a, **k)
        return bundle._replace(init_state=lambda seed, device: held.pop())

    steps.build_train_step = build
    try:
        yield
    finally:
        steps.build_train_step = real


def run(r) -> Outcome:
    from repro_torch.core import graphs, prox
    from repro_torch.core.exec_spec import ExecSpec
    from repro_torch.data.loader import LMLoader
    from repro_torch.train import steps as steps_lib, trainer

    cfg, mix, dev = r.config, r.traffic, r.device
    model = cfg["model"]
    mc = lm_common.program_config(cfg, kernels=False)
    m, B, L = mix["m"], cfg["per_node_batch"], mix["seq"]
    K, mult, n_checked = (mix["snapshot_every"], mix["snapshot_batch_mult"],
                          mix["checked_steps"])

    tokens = make_tokens(mix, model["vocab_size"], r.seed)
    loader = LMLoader(tokens, num_nodes=m, per_node_batch=B, seq_len=L,
                      seed=r.seed)
    w0 = lm_common.make_weights(model, r.seed, dev)
    params = lm_common.map_tree(
        lambda x: x[None].expand((m,) + x.shape).clone(), w0)
    del w0
    held = [steps_lib.TrainState(
        params=params, snapshot=params,
        full_grad=lm_common.map_tree(torch.zeros_like, params),
        step=torch.zeros((), dtype=torch.int32, device=dev))]
    del params
    sched = graphs.b_connected_ring_schedule(m, b=1)    # the b = 1 ring
    spec = ExecSpec(resident=True, sampling="host", device=dev)

    def train(num_steps: int, log_every: int) -> dict:
        tc = trainer.TrainerConfig(
            num_steps=num_steps, snapshot_every=K, snapshot_batch_mult=mult,
            alpha=mix["alpha"], consensus_rounds=mix["consensus_rounds"],
            algorithm="dpsvrg", gossip=mix["gossip"], log_every=log_every,
            resident=True)
        with starting_from(held):
            return trainer.train_loop(mc, prox.l1(mix["lam"]), sched, loader,
                                      tc, exec=spec)

    # set-up: a refresh and the checked first steps, a record each
    hist = train(n_checked, 1)
    state = hist["final_state"]
    losses, v_norms = hist["loss"], hist["v_norm"]
    grad_norms = _node_leaf_norms(state.full_grad)
    w0 = lm_common.make_weights(model, r.seed, dev)
    change = _node_leaf_norms(state.params, minus=w0)
    del w0, hist
    r.setup_done()

    # the window: whole rounds, a train_loop call each
    tracer = None
    if r.trace:
        from ..trace import Tracer
        tracer = Tracer(dev)
        tracer.__enter__()
    t0 = time.perf_counter()
    rounds, transfers = 0, 0
    while True:
        held.append(state)
        del state
        hist = train(K, K)
        state = hist["final_state"]
        transfers += sum(hist["transfers"].values())
        del hist
        rounds += 1
        r.sync()
        if (r.trace and rounds >= mix["trace_rounds"]) or \
                (not r.trace and time.perf_counter() - t0 >= r.seconds):
            break
    wall = time.perf_counter() - t0
    if tracer is not None:
        tracer.__exit__(None, None, None)
    peak = r.memory_peak()
    del state
    n_steps = rounds * K
    tokens_done = rounds * m * B * L * (K + mult)

    f_step, b_step = counts.lm_dpsvrg_step(model, m, B, L)
    f_ref, b_ref = counts.lm_refresh(model, m, B * mult, L)
    from ..frozen.peaks import least_seconds
    work = {"units": n_steps,
            "least_s": n_steps * least_seconds(f_step, b_step)
            + rounds * least_seconds(f_ref, b_ref)}

    from reference import lm_dpsvrg
    w0 = lm_common.make_weights(model, r.seed, dev)
    shards = torch.as_tensor(tokens.reshape(m, -1), device=dev)
    starts = lm_dpsvrg.loader_starts(r.seed, m, B, mult, n_checked,
                                     shards.shape[1] - L - 1)
    W = mix_matrix(m, mix["consensus_rounds"])

    def reference(**kw):
        return lm_dpsvrg.run(model, dict(mix, per_node_batch=B), w0, shards,
                             starts, W, steps=n_checked, **kw)

    ref = reference()
    got = {"loss": losses, "v_norm": v_norms, "grad": grad_norms,
           "change": change}
    checks = r.checks()
    compare(checks, got, ref)
    controls = {}
    for name in mix.get("controls", ()):
        ctl = r.checks()
        kw = {"precision": "tf32"} if name == "tf32" else {"fault": name}
        compare(ctl, reference(**kw), ref)
        controls[name] = ctl.as_dict()
    return Outcome(e2e={"train_tokens_per_s": tokens_done / wall},
                   attempted=n_steps, failed=0, checks=checks, work=work,
                   counters={"transfers_per_round": transfers / rounds},
                   memory_peak_bytes=peak,
                   trace=None if tracer is None else tracer.result,
                   controls=controls)


def compare(checks, got: dict, want: dict) -> None:
    """The numbers a training cell compares: each checked step's loss and
    update norm, every node's first full gradient by the worst leaf, and
    its parameters' change over the checked steps by the worst leaf, the
    leaves whose reference gradient is nought to rounding left out."""
    from ..checks import relative_gap, worst_leaf_gap
    checks.add("loss_gap", relative_gap(got["loss"], want["loss"]))
    checks.add("v_norm_gap", relative_gap(got["v_norm"], want["v_norm"]))
    checks.add("grad_gap", worst_leaf_gap(got["grad"], want["grad"]))
    med = float(np.median(list(want["grad"].values())))
    keep = [k for k, v in want["grad"].items() if v >= 1e-3 * med]
    checks.add("change_gap", worst_leaf_gap(got["change"], want["change"],
                                            keep=keep))


def _node_leaf_norms(stacked, minus=None) -> dict:
    """{"<leaf>[<node>]": norm} of a stacked (m, ...) tree, less ``minus``
    (an unstacked tree) where given."""
    out = {}
    sub = dict(lm_common.leaves(minus)) if minus is not None else {}
    for name, x in lm_common.leaves(stacked):
        for i in range(x.shape[0]):
            v = x[i] - sub[name] if name in sub else x[i]
            out[f"{name}[{i}]"] = float(torch.linalg.vector_norm(
                v.double()))
    return out
