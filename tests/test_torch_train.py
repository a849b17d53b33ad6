"""The port's decentralized LM trainer against the JAX package's
(``repro.train.trainer``) on a toy LM (2 layers, d_model 64, vocab 512,
sequences of 16, m = 4 nodes on the b=2 ring the launcher uses).

Both packages start from the same parameters (the JAX package's init, fed
to the port through numpy) and draw the same windows (the loader's
``np.random`` stream), so every record is held to the reference: losses
within rtol 1e-4 / atol 1e-5 and the final stacked parameters within atol
1e-4 (both sides run float32, summing in different orders: XLA's and
ATen's CPU kernels), step, alpha and wire-byte columns and the transfer
ledger exactly.  ``v_norm`` is held within rtol 1e-3: the reference's
``jnp.vdot`` on the CPU sums the squares of a (4, 512, 64) leaf with a
relative error of 2.8e-4 against a float64 sum, where the port's sum agrees
with it to 1e-7.  Within the port, resume is bitwise on both paths, and
checkpoints cross packages in both directions.  An MoE toy (every layer a
top-1 MoE with a shared expert, capacity dropping tokens, the aux in the
loss) is held the same way, ``v_norm`` within rtol 5e-3: the reference's
``vdot`` reads up to 2.8e-3 low on its direction.
"""

import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs, prox as jprox
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro.data.loader import LMLoader as JLoader
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.train import trainer as jtrainer
from repro_torch import checkpoint as tckpt
from repro_torch.convert import params_from_numpy
from repro_torch.core import graphs as tgraphs, prox as tprox
from repro_torch.core.exec_spec import ExecSpec as TExecSpec
from repro_torch.data.loader import LMLoader as TLoader
from repro_torch.models.api import ModelConfig as TModelConfig
from repro_torch.train import steps as tsteps, trainer as ttrainer

torch.set_num_threads(1)

TOY = dict(name="toy-train", arch_type="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)
JCFG, TCFG = JModelConfig(**TOY), TModelConfig(**TOY)
# one prox instance a package: the reference's bundle cache then serves
# every call from the same jitted steps
JPROX, TPROX = jprox.l1(1e-4), tprox.l1(1e-4)
M = 4
TOKENS = np.random.default_rng(0).integers(0, 512, size=20_000).astype(
    np.int32)
# snapshots at 0, 6, 12, 18; records at 0, 5, 10, 15, 19; checkpoints at
# 10 and 20, so a resume from step 10 restores a mid-round snapshot
TC = dict(num_steps=20, snapshot_every=6, log_every=5, alpha=0.1,
          consensus_rounds=2, seed=0, ckpt_every=10)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 1e-4
VNORM_RTOL = 1e-3
P0 = jax.device_get(jtransformer.init_params(JCFG, jax.random.PRNGKey(0)))


def _jloader():
    return JLoader(TOKENS, num_nodes=M, per_node_batch=2, seq_len=16, seed=1)


def _tloader():
    return TLoader(TOKENS, num_nodes=M, per_node_batch=2, seq_len=16, seed=1)


def _jsched():
    return jgraphs.b_connected_ring_schedule(M, b=2, seed=0)


def _tsched():
    return tgraphs.b_connected_ring_schedule(M, b=2, seed=0)


def run_torch(ckpt_dir=None, resident=False, resume=False, data=None,
              cfg=TCFG, p0=P0, **kw):
    tc = ttrainer.TrainerConfig(**dict(TC, ckpt_dir=ckpt_dir, **kw))
    with pytest.MonkeyPatch.context() as mp:
        # the port's trainer starts from the reference's parameters
        mp.setattr(tsteps.transformer, "init_params",
                   lambda cfg, seed, device: params_from_numpy(p0, device))
        return ttrainer.train_loop(
            cfg, TPROX, _tsched(), _tloader() if data is None else data, tc,
            exec=TExecSpec(resident=resident, device="cpu"), resume=resume)


def run_jax(ckpt_dir=None, resident=False, resume=False, data=None,
            cfg=JCFG, **kw):
    tc = jtrainer.TrainerConfig(**dict(TC, ckpt_dir=ckpt_dir, **kw))
    return jtrainer.train_loop(
        cfg, JPROX, _jsched(), _jloader() if data is None else data, tc,
        exec=JExecSpec(resident=resident), resume=resume)


def _stacked_by_key(tree):
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {k: v.numpy() for k, v in tckpt.flatten_with_paths(tree)}
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_matches_reference(got, want, steps=None, vnorm_rtol=VNORM_RTOL):
    """``got`` (the port's history) against ``want`` (the reference's),
    restricted to the records at ``steps`` where given."""
    idx = [want["step"].index(s) for s in (steps or want["step"])]
    assert got["step"] == [want["step"][i] for i in idx]
    for col in ("alpha", "wire_bytes"):
        assert got[col] == [want[col][i] for i in idx], col
    np.testing.assert_allclose(got["loss"], [want["loss"][i] for i in idx],
                               **LOSS_TOL)
    np.testing.assert_allclose(got["v_norm"],
                               [want["v_norm"][i] for i in idx],
                               rtol=vnorm_rtol)
    gp = _stacked_by_key(got["final_state"].params)
    wp = _stacked_by_key(want["final_state"].params)
    assert sorted(gp) == sorted(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert int(got["final_state"].step) == int(want["final_state"].step)


def assert_bitwise(got, want):
    """Two runs of the port: equal records and equal bits in every state
    leaf."""
    by_step = dict(zip(want["step"], zip(want["loss"], want["v_norm"],
                                         want["wire_bytes"], want["alpha"])))
    assert got["step"]
    for s, l, v, w, a in zip(got["step"], got["loss"], got["v_norm"],
                             got["wire_bytes"], got["alpha"]):
        assert by_step[s] == (l, v, w, a)
    for (k, x), (_, y) in zip(
            tckpt.flatten_with_paths(got["final_state"]),
            tckpt.flatten_with_paths(want["final_state"])):
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every full 20-step run, once: the reference's host loop for both
    rules and its resident DSPG run, the port's host and resident runs of
    both rules, each checkpointing at steps 10 and 20."""
    out = {}
    for alg in ("dpsvrg", "dspg"):
        for where, fn in (("jax", run_jax), ("torch", run_torch)):
            for resident in (False, True):
                if where == "jax" and resident and alg == "dpsvrg":
                    continue            # its compile is the costliest
                d = str(tmp_path_factory.mktemp(f"{where}_{alg}_{resident}"))
                out[where, alg, resident] = (
                    fn(ckpt_dir=d, resident=resident, algorithm=alg), d)
    return out


@pytest.mark.parametrize("alg", ["dpsvrg", "dspg"])
def test_host_loop_matches_the_reference(runs, alg):
    got, want = runs["torch", alg, False][0], runs["jax", alg, False][0]
    assert got["step"] == [0, 5, 10, 15, 19]
    assert_matches_reference(got, want)
    assert got["transfers"] == want["transfers"] == {"h2d": 20, "d2h": 7}
    assert np.all(np.isfinite(got["loss"]))


@pytest.mark.parametrize("alg", ["dpsvrg", "dspg"])
def test_resident_matches_the_host_loop_and_the_reference(runs, alg):
    got, host = runs["torch", alg, True][0], runs["torch", alg, False][0]
    assert got["step"] == host["step"]
    np.testing.assert_allclose(got["loss"], host["loss"], **LOSS_TOL)
    np.testing.assert_allclose(got["v_norm"], host["v_norm"], rtol=1e-4)
    assert got["wire_bytes"] == host["wire_bytes"]
    assert got["alpha"] == host["alpha"]
    for k, x in tckpt.flatten_with_paths(got["final_state"].params):
        y = dict(tckpt.flatten_with_paths(host["final_state"].params))[k]
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    assert_matches_reference(got, runs["jax", alg, False][0])
    # one staging transfer, one pull a record window and one a checkpoint:
    # the reference's own resident ledger
    assert got["transfers"] == {"h2d": 1, "d2h": 7}
    if alg == "dspg":
        assert got["transfers"] == runs["jax", alg, True][0]["transfers"]


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("alg", ["dpsvrg", "dspg"])
def test_resume_from_a_periodic_checkpoint_is_bitwise(runs, tmp_path, alg,
                                                      resident):
    full, d = runs["torch", alg, resident]
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    assert tckpt.latest_step(crash) == 10
    res = run_torch(ckpt_dir=crash, resident=resident, resume=True,
                    algorithm=alg)
    assert res["step"] == [10, 15, 19]
    assert_bitwise(res, full)
    assert int(res["final_state"].step) == 20
    assert tckpt.latest_step(crash) == 20
    # the restore counts one upload; the rest of the ledger is the run's
    assert res["transfers"]["h2d"] == (1 if resident else 10) + 1


def test_the_port_resumes_a_reference_checkpoint(runs, tmp_path):
    want, d = runs["jax", "dpsvrg", False]
    crash = str(tmp_path / "from_jax")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    got = run_torch(ckpt_dir=crash, resume=True)
    assert_matches_reference(got, want, steps=[10, 15, 19])


def test_the_reference_resumes_a_port_checkpoint(runs, tmp_path):
    want, d = runs["torch", "dpsvrg", False]
    crash = str(tmp_path / "from_torch")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    got = run_jax(ckpt_dir=crash, resume=True)
    # the reference's continuation, held to the port's own run
    assert got["step"] == [10, 15, 19]
    np.testing.assert_allclose(got["loss"], want["loss"][2:], **LOSS_TOL)
    assert got["wire_bytes"] == want["wire_bytes"][2:]
    gp = _stacked_by_key(got["final_state"].params)
    for k, v in _stacked_by_key(want["final_state"].params).items():
        np.testing.assert_allclose(gp[k], v, rtol=0, atol=PARAM_ATOL)


def test_legacy_batch_iterator_matches_the_reference():
    def batches(ld):
        for t, l in ld:
            yield {"tokens": t, "labels": l}

    kw = dict(num_steps=8, ckpt_every=0, algorithm="dspg")
    want = run_jax(data=batches(_jloader()), **kw)
    got = run_torch(data=batches(_tloader()), **kw)
    assert_matches_reference(got, want)


def test_compressed_gossip_matches_the_reference_on_both_paths():
    """int8 gossip with error feedback: a float32 rounding difference can
    move a quantized code to its neighbour, so parameters are held within
    one quantization step of their leaf (max |x| / 127) instead of 1e-4;
    the losses keep the float32 tolerance."""
    kw = dict(num_steps=8, ckpt_every=0, algorithm="dspg",
              gossip="compressed")
    want = run_jax(**kw)
    for resident in (False, True):
        got = run_torch(resident=resident, **kw)
        assert got["step"] == want["step"]
        assert got["wire_bytes"] == want["wire_bytes"]
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
        gp = _stacked_by_key(got["final_state"].params)
        for k, v in _stacked_by_key(want["final_state"].params).items():
            step = np.abs(v).max() / 127
            np.testing.assert_allclose(gp[k], v, rtol=0, atol=step,
                                       err_msg=k)
        assert got["final_state"].mix_state is not None


@pytest.mark.parametrize("schedule", ["constant", "wsd", "cosine"])
@pytest.mark.parametrize("alg", ["dpsvrg", "dspg"])
def test_realized_alpha_equals_the_reference(alg, schedule):
    kw = dict(num_steps=40, alpha=0.1, lr_schedule=schedule, algorithm=alg)
    jtc, ttc = jtrainer.TrainerConfig(**kw), ttrainer.TrainerConfig(**kw)
    from repro.core import algorithm as jalgorithm
    from repro_torch.core import algorithm as talgorithm
    warns = []
    for pkg, tc, algo in ((jtrainer, jtc, jalgorithm),
                          (ttrainer, ttc, talgorithm)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn = pkg._realized_alpha_fn(tc, algo.UPDATE_RULES[alg])
        warns.append([str(w.message) for w in caught
                      if w.category is RuntimeWarning])
        if pkg is jtrainer:
            want = [float(fn(k)) for k in range(40)]
    assert [float(fn(k)) for k in range(40)] == want
    assert warns[0] == warns[1]
    assert bool(warns[1]) == (alg == "dspg" and schedule != "constant")


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _tc(**kw):
    return dict(num_steps=4, **kw)


REFUSALS = [
    # (name, port call kwargs, reference call kwargs or None, exception)
    ("scan", dict(spec=dict(scan=True)), dict(spec=dict(scan=True)),
     ValueError),
    ("kernel", dict(spec=dict(resident=True, kernel="fused")),
     dict(spec=dict(resident=True, kernel="pallas")), ValueError),
    ("device_transitions", dict(spec=dict(resident=True,
                                          device_transitions=False)),
     dict(spec=dict(resident=True, device_transitions=False)), ValueError),
    ("snapshot_batch_iter", dict(snapshot_batch_iter=iter([])),
     dict(snapshot_batch_iter=iter([])), ValueError),
    ("resume_without_ckpt_dir", dict(resume=True), dict(resume=True),
     ValueError),
    ("resident_iterator", dict(spec=dict(resident=True), data="iterator"),
     dict(spec=dict(resident=True), data="iterator"), ValueError),
]


def _call(pkg, kw):
    kw = dict(kw)
    spec = kw.pop("spec", {})
    data = kw.pop("data", None)
    if pkg == "torch":
        ld = _tloader()
        args = (TCFG, TPROX, _tsched(), iter(ld) if data else ld,
                ttrainer.TrainerConfig(**_tc()))
        return ttrainer.train_loop(
            *args, exec=TExecSpec(device="cpu", **spec), **kw)
    ld = _jloader()
    args = (JCFG, JPROX, _jsched(), iter(ld) if data else ld,
            jtrainer.TrainerConfig(**_tc()))
    return jtrainer.train_loop(*args, exec=JExecSpec(**spec), **kw)


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_raise_the_reference_exception_types(case):
    _, tkw, jkw, exc = case
    with pytest.raises(exc) as jerr:
        _call("jax", jkw)
    with pytest.raises(exc) as terr:
        _call("torch", tkw)
    assert type(terr.value) is type(jerr.value)


@pytest.mark.parametrize("flags", [dict(use_flash=True),
                                   dict(use_fused_norm=True),
                                   dict(use_flash=True, use_fused_norm=True)])
def test_train_loop_refuses_kernel_configs(flags):
    """The RMSNorm and flash kernels have no backward, so a config that
    routes the forward through them cannot be trained."""
    cfg = TCFG.scaled(**flags)
    with pytest.raises(ValueError, match="no backward"):
        ttrainer.train_loop(cfg, TPROX, _tsched(), _tloader(),
                            ttrainer.TrainerConfig(**_tc()),
                            exec=TExecSpec(device="cpu"))


def test_unported_paths_raise_by_roadmap_item():
    """Sharded state runs on the host loop (tests/test_torch_mesh_lm.py);
    what the reference refuses, the port refuses with its messages:
    shard='cells' and shard='nodes' in train_loop, and sharded state on
    the resident path.  A mesh without a plan (or the reverse) names the
    other."""
    for shard, match in (("cells", "use train_sweep"),
                         ("nodes", "shard='nodes'")):
        with pytest.raises(ValueError, match=match):
            jtrainer.train_loop(JCFG, JPROX, _jsched(), _jloader(),
                                jtrainer.TrainerConfig(**_tc()),
                                exec=JExecSpec(resident=True, shard=shard))
        with pytest.raises(ValueError, match=match):
            ttrainer.train_loop(TCFG, TPROX, _tsched(), _tloader(),
                                ttrainer.TrainerConfig(**_tc()),
                                exec=TExecSpec(resident=True, shard=shard,
                                               device="cpu"))
    for kw in (dict(mesh=object()), dict(plan=object())):
        with pytest.raises(ValueError, match="does not support sharded"):
            ttrainer.train_loop(TCFG, TPROX, _tsched(), _tloader(),
                                ttrainer.TrainerConfig(**_tc()),
                                exec=TExecSpec(resident=True, device="cpu"),
                                **kw)
    with pytest.raises(ValueError, match="got only plan"):
        ttrainer.train_loop(TCFG, TPROX, _tsched(), _tloader(),
                            ttrainer.TrainerConfig(**_tc()),
                            exec=TExecSpec(device="cpu"), plan=object())


def test_train_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train_loop(TCFG, TPROX, _tsched(), _tloader(),
                            ttrainer.TrainerConfig(**_tc()))


def test_trainer_keep_last_and_final_checkpoint(tmp_path):
    d = str(tmp_path / "keep")
    run_torch(ckpt_dir=d, resident=True, num_steps=12, ckpt_every=3,
              keep_last=2, algorithm="dspg")
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == ["step_00000009", "step_00000012"]
    d = str(tmp_path / "final")
    hist = run_torch(ckpt_dir=d, num_steps=5, ckpt_every=0,
                     algorithm="dspg")
    assert tckpt.latest_step(d) == 5
    tree, step, md = tckpt.restore(d, {"state": hist["final_state"]})
    assert step == md["step"] == 5 and md["loader"] is not None
    assert md["algorithm"] == "dspg"
    for (k, x), (_, y) in zip(tckpt.flatten_with_paths(tree["state"]),
                              tckpt.flatten_with_paths(hist["final_state"])):
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# an MoE model: every layer a top-1 MoE of 4 experts with a shared expert,
# the aux in the loss; capacity (10 slots an expert for a node's 32 tokens)
# drops tokens, and the node vmap runs through the dispatch
# ---------------------------------------------------------------------------

MOE_TOY = dict(TOY, name="toy-moe", arch_type="moe", moe_experts=4,
               moe_top_k=1, moe_period=1, moe_shared_expert=True)
MOE_JCFG, MOE_TCFG = JModelConfig(**MOE_TOY), TModelConfig(**MOE_TOY)
MOE_P0 = jax.device_get(jtransformer.init_params(MOE_JCFG,
                                                 jax.random.PRNGKey(0)))
# the reference's v_norm (``jnp.vdot`` on the CPU, summing in float32)
# reads up to 2.8e-3 low on this model's direction; summed with
# ``jnp.sum`` it agrees with the port's
MOE_VNORM_RTOL = 5e-3


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The reference's host loop and the port's host and resident runs of
    the MoE toy, DPSVRG, each checkpointing at steps 10 and 20."""
    out = {}
    for where, resident in (("jax", False), ("torch", False),
                            ("torch", True)):
        d = str(tmp_path_factory.mktemp(f"moe_{where}_{resident}"))
        if where == "jax":
            out[where, resident] = (run_jax(ckpt_dir=d, cfg=MOE_JCFG), d)
        else:
            out[where, resident] = (run_torch(
                ckpt_dir=d, resident=resident, cfg=MOE_TCFG, p0=MOE_P0), d)
    return out


@pytest.mark.parametrize("resident", [False, True])
def test_moe_train_loop_matches_the_reference(moe_runs, resident):
    got, want = moe_runs["torch", resident][0], moe_runs["jax", False][0]
    assert got["step"] == [0, 5, 10, 15, 19]
    assert_matches_reference(got, want, vnorm_rtol=MOE_VNORM_RTOL)
    assert np.all(np.isfinite(got["loss"]))


def test_moe_resume_is_bitwise_and_the_reference_continues_it(moe_runs,
                                                              tmp_path):
    full, d = moe_runs["torch", True]
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    res = run_torch(ckpt_dir=crash, resident=True, resume=True,
                    cfg=MOE_TCFG, p0=MOE_P0)
    assert res["step"] == [10, 15, 19]
    assert_bitwise(res, full)
    # the reference resumes the port's MoE checkpoint
    crash = str(tmp_path / "to_jax")
    shutil.copytree(moe_runs["torch", False][1], crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    got = run_jax(ckpt_dir=crash, resume=True, cfg=MOE_JCFG)
    assert_matches_reference(res, got, vnorm_rtol=MOE_VNORM_RTOL)


def test_moe_train_sweep_cells_equal_sequential_runs():
    """Two (lambda, alpha) cells of the MoE toy under the cell vmap (nested
    on the node vmap through the dispatch), each equal to its own
    sequential resident train_loop."""
    grid = {"lam": [1e-4, 1e-3], "alpha": [0.1, 0.05]}
    tc = ttrainer.TrainerConfig(**dict(TC, num_steps=8, snapshot_every=4,
                                       log_every=4, ckpt_every=0))
    spec = TExecSpec(resident=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps.transformer, "init_params",
                   lambda cfg, seed, device: params_from_numpy(MOE_P0,
                                                               device))
        sweep = ttrainer.train_sweep(MOE_TCFG, tprox.l1, _tsched(),
                                     _tloader(), tc, grid, spec, mode="zip")
        for i, (lam, alpha) in enumerate(zip(grid["lam"], grid["alpha"])):
            one = ttrainer.train_loop(
                MOE_TCFG, tprox.l1(lam), _tsched(), _tloader(),
                ttrainer.TrainerConfig(**dict(
                    TC, num_steps=8, snapshot_every=4, log_every=4,
                    ckpt_every=0, alpha=alpha)), exec=spec)
            assert sweep["step"] == one["step"]
            np.testing.assert_allclose(np.asarray(sweep["loss"])[:, i],
                                       one["loss"], **LOSS_TOL)
            np.testing.assert_allclose(np.asarray(sweep["v_norm"])[:, i],
                                       one["v_norm"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the SSM smoke variants: xlstm-350m's (an mLSTM and an sLSTM block, the
# time loops under the node vmap and autograd) and jamba-1.5-large-398b's
# (attention + swiglu, then Mamba + a 4-expert top-2 MoE; held as the MoE
# toy is, v_norm within rtol 5e-3).  xlstm's training is chaotic at the
# file's alpha 0.1: the reference's own run from its init scaled by
# 1 + 1e-7 leaves its unscaled run by 0.23 in the loss at step 5 and 0.88
# at step 10.  So its whole runs are held to the reference at step 0, and
# its steps one by one, each from the reference's state.
# ---------------------------------------------------------------------------

SSM_ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]


def _ssm_cfgs(arch):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    p0 = jax.device_get(jtransformer.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    return jcfg, tcfg, p0


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_runs(request, tmp_path_factory):
    """One SSM smoke variant's DPSVRG runs: the reference's host loop and
    the port's host and resident runs, each checkpointing at steps 10 and
    20."""
    jcfg, tcfg, p0 = _ssm_cfgs(request.param)
    out = {"arch": request.param, "cfgs": (jcfg, tcfg, p0)}
    for where, resident in (("jax", False), ("torch", False),
                            ("torch", True)):
        d = str(tmp_path_factory.mktemp(f"{request.param}_{where}_"
                                        f"{resident}"))
        if where == "jax":
            out[where, resident] = (run_jax(ckpt_dir=d, cfg=jcfg), d)
        else:
            out[where, resident] = (run_torch(
                ckpt_dir=d, resident=resident, cfg=tcfg, p0=p0), d)
    return out


def _held_to_the_reference(arch, got, want, steps=None):
    """jamba's run record by record and in its final parameters; xlstm's
    (chaotic) in its first record, its columns and its step list."""
    if arch != "xlstm-350m":
        assert_matches_reference(got, want, steps, vnorm_rtol=MOE_VNORM_RTOL)
        return
    idx = [want["step"].index(s) for s in (steps or want["step"])]
    assert got["step"] == [want["step"][i] for i in idx]
    for col in ("alpha", "wire_bytes"):
        assert got[col] == [want[col][i] for i in idx], col
    np.testing.assert_allclose(got["loss"][0], want["loss"][idx[0]],
                               **LOSS_TOL)
    np.testing.assert_allclose(got["v_norm"][0], want["v_norm"][idx[0]],
                               rtol=MOE_VNORM_RTOL)
    assert np.all(np.isfinite(got["loss"]))


@pytest.mark.parametrize("resident", [False, True])
def test_ssm_train_loop_matches_the_reference(ssm_runs, resident):
    got, want = ssm_runs["torch", resident][0], ssm_runs["jax", False][0]
    assert got["step"] == [0, 5, 10, 15, 19]
    _held_to_the_reference(ssm_runs["arch"], got, want)
    assert np.all(np.isfinite(got["loss"]))
    host = ssm_runs["torch", False][0]
    np.testing.assert_allclose(got["loss"], host["loss"], **LOSS_TOL)
    assert got["transfers"] == ({"h2d": 1, "d2h": 7} if resident else
                                want["transfers"])


def test_ssm_resume_is_bitwise_and_checkpoints_cross_packages(ssm_runs,
                                                              tmp_path):
    """The port resumes its own step-10 checkpoint bit for bit, the
    reference's checkpoint as the reference continues it, and the
    reference resumes the port's."""
    arch = ssm_runs["arch"]
    jcfg, tcfg, p0 = ssm_runs["cfgs"]
    full, d = ssm_runs["torch", True]
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000020"))
    res = run_torch(ckpt_dir=crash, resident=True, resume=True, cfg=tcfg,
                    p0=p0)
    assert res["step"] == [10, 15, 19]
    assert_bitwise(res, full)
    want, jd = ssm_runs["jax", False]
    from_jax = str(tmp_path / "from_jax")
    shutil.copytree(jd, from_jax)
    shutil.rmtree(os.path.join(from_jax, "step_00000020"))
    got = run_torch(ckpt_dir=from_jax, resume=True, cfg=tcfg, p0=p0)
    _held_to_the_reference(arch, got, want, steps=[10, 15, 19])
    to_jax = str(tmp_path / "to_jax")
    shutil.copytree(ssm_runs["torch", False][1], to_jax)
    shutil.rmtree(os.path.join(to_jax, "step_00000020"))
    got = run_jax(ckpt_dir=to_jax, resume=True, cfg=jcfg)
    _held_to_the_reference(arch, res, got)


def test_xlstm_train_steps_match_the_reference_step_by_step():
    """Twelve DPSVRG steps with snapshot refreshes at 0 and 6: each of the
    port's train and snapshot steps, from the reference's state, equals
    the reference's step (loss, new parameters and the refreshed full
    gradient at the file's tolerances; v_norm within rtol 5e-3, the
    reference's ``vdot`` reading it low, as for the MoE toy)."""
    from repro.train import steps as jsteps
    jcfg, tcfg, _ = _ssm_cfgs("xlstm-350m")
    jb = jsteps.build_train_step(jcfg, JPROX, M, algorithm="dpsvrg",
                                 donate=False)
    tb = tsteps.build_train_step(tcfg, TPROX, M, algorithm="dpsvrg")
    ld, sched = _jloader(), _jsched()

    def to_port(state):
        return tsteps.TrainState(*(
            params_from_numpy(jax.tree.map(np.asarray, f), "cpu")
            for f in state[:4]))

    def leaves_close(got, want):
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=PARAM_ATOL)

    jstate = jb.init_state(jax.random.PRNGKey(0))
    for k in range(12):
        if k % 6 == 0:
            big = ld.gather(ld.sample_starts(8))
            jnext = jb.snapshot_step(jstate, {"tokens": jnp.asarray(big[0]),
                                              "labels": jnp.asarray(big[1])})
            tnext = tb.snapshot_step(to_port(jstate), {
                "tokens": torch.from_numpy(big[0]),
                "labels": torch.from_numpy(big[1])})
            leaves_close(tnext.full_grad, jnext.full_grad)
            jstate = jnext
        toks, labels = ld.sample()
        phi = np.asarray(sched.consensus_rounds(k, 2), np.float32)
        jnext, jm = jb.train_step(jstate, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)},
                                  jnp.asarray(phi), 0.1)
        tnext, tm = tb.train_step(to_port(jstate), {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}, torch.from_numpy(phi), 0.1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(float(tm["v_norm"]), float(jm["v_norm"]),
                                   rtol=MOE_VNORM_RTOL)
        leaves_close(tnext.params, jnext.params)
        jstate = jnext
