"""The port's ``trainer.train_sweep`` against the JAX package's
(``repro.train.trainer.train_sweep``) on a toy LM (1 layer, d_model 32,
vocab 64, sequences of 16, m = 4 nodes on the b=2 ring): the tests of
``tests/test_trainer_sweep.py`` that run on one device.

Both packages start from the same parameters (the JAX package's init, fed
to the port through numpy) and draw the same windows (the loader's
``np.random`` stream, shared by every cell), so each cell is held to the
reference's cell and to the port's own sequential resident ``train_loop``
of that cell: losses within rtol 1e-4 / atol 1e-5, ``v_norm`` within rtol
1e-3 against the reference (its CPU ``vdot`` sums in another order) and
1e-4 within the port, step, alpha and wire-byte columns exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs, prox as jprox
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro.data.loader import LMLoader as JLoader
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import graphs as tgraphs, prox as tprox
from repro_torch.core.exec_spec import ExecSpec as TExecSpec
from repro_torch.data.loader import LMLoader as TLoader
from repro_torch.models.api import ModelConfig as TModelConfig
from repro_torch.train import steps as tsteps, trainer as ttrainer

torch.set_num_threads(1)

TINY = dict(name="tiny-sw", arch_type="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64)
JCFG, TCFG = JModelConfig(**TINY), TModelConfig(**TINY)
M = 4
TOKENS = np.random.default_rng(7).integers(0, 64, size=2400).astype(np.int32)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
P0 = jax.device_get(jtransformer.init_params(JCFG, jax.random.PRNGKey(0)))
LAMS = [1e-4, 1e-3]
CPU = TExecSpec(resident=True, device="cpu")


def _loader(pkg, seed=1):
    cls = JLoader if pkg == "jax" else TLoader
    return cls(TOKENS, num_nodes=M, per_node_batch=2, seq_len=16, seed=seed)


def _sched(graphs):
    return graphs.b_connected_ring_schedule(M, b=2, seed=0)


def _tc(pkg, **kw):
    base = dict(num_steps=9, snapshot_every=4, log_every=4, alpha=0.05,
                consensus_rounds=2, seed=0)
    base.update(kw)
    return (jtrainer if pkg == "jax" else ttrainer).TrainerConfig(**base)


@pytest.fixture
def reference_init(monkeypatch):
    """The port starts from the reference's parameters."""
    monkeypatch.setattr(
        tsteps.transformer, "init_params",
        lambda cfg, seed, device: params_from_numpy(P0, device))


def torch_sweep(grid, build=tprox.l1, mode="product", **kw):
    return ttrainer.train_sweep(TCFG, build, _sched(tgraphs), _loader("t"),
                                _tc("t", **kw), grid, CPU, mode=mode)


def torch_loop(lam, **kw):
    return ttrainer.train_loop(TCFG, tprox.l1(lam), _sched(tgraphs),
                               _loader("t"), _tc("t", **kw), exec=CPU)


def jax_sweep(grid, build=jprox.l1, mode="product", **kw):
    return jtrainer.train_sweep(JCFG, build, _sched(jgraphs), _loader("jax"),
                                _tc("jax", **kw), grid, mode=mode)


def assert_cell(got, i, want, j=None, vnorm_rtol=1e-4):
    """Cell ``i`` of the sweep ``got`` against the history ``want`` (a
    sequential run, or cell ``j`` of another sweep)."""
    pick = (lambda h, col: np.asarray(h[col])[:, j]) if j is not None \
        else (lambda h, col: np.asarray(h[col]))
    assert got["step"] == want["step"]
    np.testing.assert_allclose(np.asarray(got["loss"])[:, i],
                               pick(want, "loss"), **LOSS_TOL)
    np.testing.assert_allclose(np.asarray(got["v_norm"])[:, i],
                               pick(want, "v_norm"), rtol=vnorm_rtol)
    np.testing.assert_array_equal(np.asarray(got["alpha"])[:, i],
                                  np.asarray(pick(want, "alpha"),
                                             np.float32))
    assert list(got["wire_bytes"]) == list(want["wire_bytes"])


@pytest.mark.parametrize("algorithm", ["dpsvrg", "dspg"])
def test_sweep_cells_match_sequential_train_loop(reference_init, algorithm):
    """Each cell equals the reference's cell and a sequential resident
    train_loop of the port with the same prox over a fresh same-seed
    loader (one shared host-drawn stream)."""
    res = torch_sweep({"lam": LAMS}, algorithm=algorithm)
    want = jax_sweep({"lam": LAMS}, algorithm=algorithm)
    assert res["grid"] == want["grid"] == [{"lam": lam} for lam in LAMS]
    for i, lam in enumerate(LAMS):
        assert_cell(res, i, want, j=i, vnorm_rtol=1e-3)
        assert_cell(res, i, torch_loop(lam, algorithm=algorithm))
    assert np.all(np.isfinite(res["loss"]))


def test_sweep_alpha_axis_is_driver_level(reference_init):
    """The reserved "alpha" axis overrides tc.alpha per cell without being
    passed to build."""
    alphas = [0.05, 0.02]

    def build():            # no alpha parameter: the axis must not reach it
        return tprox.l1(1e-4)

    res = torch_sweep({"alpha": alphas}, build=build)
    assert np.asarray(res["alpha"]).shape == (len(res["step"]), 2)
    want = jax_sweep({"alpha": alphas}, build=lambda: jprox.l1(1e-4))
    for i, a in enumerate(alphas):
        seq = torch_loop(1e-4, alpha=a)
        assert_cell(res, i, seq)
        assert_cell(res, i, want, j=i, vnorm_rtol=1e-3)


def test_sweep_is_one_staged_program():
    """One staging transfer and one metrics pull for the whole grid, the
    reference's ledger and return keys, the cell axis in front of every
    state leaf."""
    grid = {"lam": LAMS, "alpha": [0.05, 0.02]}
    res = torch_sweep(grid)
    want = jax_sweep(grid)
    assert len(res["grid"]) == 4 and res["grid"] == want["grid"]
    assert res["transfers"] == want["transfers"] == {"h2d": 1, "d2h": 1}
    assert sorted(res) == sorted(want)
    leaves = torch.utils._pytree.tree_leaves(res["final_state"].params)
    assert all(leaf.shape[:2] == (4, M) for leaf in leaves)
    assert res["final_state"].step.tolist() == [9] * 4


def test_sweep_zip_mode_pairs_axes(reference_init):
    grid = {"lam": LAMS, "alpha": [0.05, 0.02]}
    res = torch_sweep(grid, mode="zip")
    assert res["grid"] == [{"lam": 1e-4, "alpha": 0.05},
                           {"lam": 1e-3, "alpha": 0.02}]
    want = jax_sweep(grid, mode="zip")
    for i in range(2):
        assert_cell(res, i, want, j=i, vnorm_rtol=1e-3)


# ---------------------------------------------------------------------------
# refusals: the reference's messages and exception types
# ---------------------------------------------------------------------------

def _refused(pkg, *, spec=None, tc_kw=None, data=None, build=None):
    if pkg == "jax":
        return jtrainer.train_sweep(
            JCFG, build or jprox.l1, _sched(jgraphs),
            _loader("jax") if data is None else data,
            _tc("jax", **(tc_kw or {})), {"lam": [1e-4]},
            exec=None if spec is None else JExecSpec(**spec))
    return ttrainer.train_sweep(
        TCFG, build or tprox.l1, _sched(tgraphs),
        _loader("t") if data is None else data, _tc("t", **(tc_kw or {})),
        {"lam": [1e-4]},
        exec=TExecSpec(**dict(dict(resident=True, device="cpu"),
                              **(spec or {}))))


def test_sweep_rejects_non_resident_spec():
    for pkg in ("jax", "t"):
        with pytest.raises(ValueError, match="device-resident"):
            _refused(pkg, spec=dict(resident=False))


def test_sweep_rejects_device_sampling():
    for pkg in ("jax", "t"):
        with pytest.raises(ValueError, match="sampling='device'"):
            _refused(pkg, spec=dict(resident=True, sampling="device"))


def test_sweep_rejects_node_sharding():
    """Both packages refuse shard='nodes' in train_sweep with the
    reference's message (it splits the cell axis: shard='cells', run
    across ranks in tests/test_torch_mesh_lm.py), and a cell-split sweep
    whose transport exchanges over a node axis of ranks."""
    for pkg in ("jax", "t"):
        with pytest.raises(ValueError, match="shard='cells'"):
            _refused(pkg, spec=dict(resident=True, shard="nodes"))
        with pytest.raises(ValueError, match="'ppermute' transport"):
            _refused(pkg, spec=dict(resident=True, shard="cells",
                                    gossip="ppermute"))


def test_sweep_rejects_checkpointing_cells(tmp_path):
    for pkg in ("jax", "t"):
        with pytest.raises(ValueError, match="checkpoint"):
            _refused(pkg, tc_kw=dict(ckpt_dir=str(tmp_path)))
        with pytest.raises(ValueError, match="trackers"):
            _refused(pkg, tc_kw=dict(tracker="jsonl:" + str(tmp_path / "m")))


def test_sweep_rejects_non_loader_data():
    for pkg in ("jax", "t"):
        with pytest.raises(ValueError, match="LMLoader"):
            _refused(pkg, data={"tokens": TOKENS})


def test_sweep_rejects_non_prox_build():
    for pkg in ("jax", "t"):
        with pytest.raises(TypeError, match="must return a Prox"):
            _refused(pkg, build=lambda lam: lam)


def test_sweep_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.train_sweep(TCFG, tprox.l1, _sched(tgraphs), _loader("t"),
                             _tc("t"), {"lam": LAMS})


def test_sweep_refuses_kernel_configs():
    """As train_loop: the RMSNorm and flash kernels have no backward."""
    with pytest.raises(ValueError, match="no backward"):
        ttrainer.train_sweep(TCFG.scaled(use_flash=True), tprox.l1,
                             _sched(tgraphs), _loader("t"), _tc("t"),
                             {"lam": LAMS}, CPU)


def test_compressed_gossip_cells_match_sequential_runs():
    """A stateful transport: each cell's error feedback rides its own
    mix state under the cell vmap."""
    res = torch_sweep({"lam": LAMS}, algorithm="dspg", gossip="compressed")
    assert res["final_state"].mix_state is not None
    for i, lam in enumerate(LAMS):
        assert_cell(res, i, torch_loop(lam, algorithm="dspg",
                                       gossip="compressed"))
