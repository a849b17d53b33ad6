"""Batched sweeps of the port (``repro_torch.core.sweep``) against the JAX
package's ``sweep.run_sweep``, on the CPU.

The same numpy data and grids go through both packages for every
registered algorithm (Algorithm 2 included) on a (λ × seed) grid: the
port's batched sweep and its sequential resident sweep must equal the JAX
package's batched sweep — the counting columns (steps, epochs, comm
rounds, wire bytes) exactly, the objective within rtol 1e-4 / atol 1e-6 and
the consensus within rtol 1e-3 / atol 1e-6, the tolerances of the
reference's own batched-vs-sequential tests (``tests/test_runner_sweep.py``):
both packages run the same float32 arithmetic summed in other orders, and
the consensus distance, a norm of differences of nearly equal iterates,
loses digits to cancellation.  Beside that: zip grids over a
``"schedule"`` axis (one mixing matrix a cell), loopless coin flips per
cell, the ragged-grid, empty-grid and zip-length errors, the (1, 1)
transfer ledger, and ``kernel="fused"`` on the CPU (the cell-batched plain
version, reached through the fused step's vmap rule) against the plain
step.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as jalgorithm, gossip as jgossip, \
    graphs as jgraphs, inexact as jinexact, prox as jprox, sweep as jsweep
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro.data import synthetic as jsynthetic
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    inexact as tinexact, prox as tprox, runner as trunner, sweep as tsweep
from repro_torch.core.exec_spec import ExecSpec as TExecSpec
from repro_torch.kernels.fused_update import ops as fused_ops

torch.set_num_threads(1)

M, N, D = 4, 128, 12
OBJ_TOL = dict(rtol=1e-4, atol=1e-6)
CONS_TOL = dict(rtol=1e-3, atol=1e-6)

ALGORITHMS = ["dpsvrg", "dspg", "dpg", "gt_svrg", "loopless_dpsvrg", "dvr",
              "inexact_prox_svrg"]
# the algorithms with a fused twin
FUSED = ["dpsvrg", "dspg", "dpg", "loopless_dpsvrg", "dvr"]


def jax_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return jnp.mean(-y * logits + jnp.log1p(jnp.exp(logits)))


def torch_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))


@functools.lru_cache(maxsize=None)
def _parts():
    ds = jsynthetic.make_classification(n=N, d=D, seed=0)
    return jsynthetic.partition_per_node(ds, M)


@functools.lru_cache(maxsize=None)
def _jdata():
    return {k: jnp.asarray(v) for k, v in _parts().items()}


@functools.lru_cache(maxsize=None)
def _tdata():
    return params_from_numpy(_parts(), "cpu")


def _sched(pkg, b=2, seed=0):
    return pkg.b_connected_ring_schedule(M, b=b, seed=seed)


def _make(pkg, name, problem):
    """The reference test's hyperparameters, one factory per package."""
    if name == "dpsvrg":
        return pkg.dpsvrg_algorithm(problem, pkg.DPSVRGHyperParams(
            alpha=0.3, beta=1.2, n0=3, num_outer=4))
    if name == "dspg":
        return pkg.dspg_algorithm(problem, pkg.DSPGHyperParams(alpha0=0.3),
                                  37)
    if name == "dpg":
        return pkg.dpg_algorithm(problem, 0.3, 12)
    if name == "gt_svrg":
        return pkg.gt_svrg_algorithm(problem, 0.1, 3, 8)
    if name == "loopless_dpsvrg":
        return pkg.loopless_dpsvrg_algorithm(problem, 0.3, 33,
                                             snapshot_prob=0.25)
    if name == "dvr":
        return pkg.dvr_algorithm(problem, 0.3, 33, snapshot_prob=0.25)
    raise KeyError(name)


def _builds(name):
    """(JAX cell factory, port cell factory) with a λ axis."""
    if name == "inexact_prox_svrg":
        # Algorithm 2 on one virtual node holding the whole dataset
        flat = {k: v.reshape(1, -1, *v.shape[2:])
                for k, v in _parts().items()}
        jflat = {k: jnp.asarray(v) for k, v in flat.items()}
        tflat = params_from_numpy(flat, "cpu")

        def jbuild(lam=0.01):
            p = jalgorithm.Problem(jax_loss, jprox.l1(lam),
                                   jnp.zeros((1, D)), jflat)
            hp = jinexact.InexactHyperParams(alpha=0.3, beta=1.2, n0=3,
                                             num_outer=3)
            return jalgorithm.ALGORITHMS[name](p, hp), p

        def tbuild(lam=0.01):
            p = talgorithm.Problem(torch_loss, tprox.l1(lam),
                                   torch.zeros(1, D), tflat)
            hp = tinexact.InexactHyperParams(alpha=0.3, beta=1.2, n0=3,
                                             num_outer=3)
            return talgorithm.ALGORITHMS[name](p, hp), p

        return jbuild, tbuild

    jx0 = jgossip.stack_tree(jnp.zeros(D), M)
    tx0 = torch.zeros(M, D)

    def jbuild(lam=0.01):
        p = jalgorithm.Problem(jax_loss, jprox.l1(lam), jx0, _jdata())
        return _make(jalgorithm, name, p), p

    def tbuild(lam=0.01):
        p = talgorithm.Problem(torch_loss, tprox.l1(lam), tx0, _tdata())
        return _make(talgorithm, name, p), p

    return jbuild, tbuild


def _schedules(name):
    if name == "inexact_prox_svrg":
        return (jgraphs.static_schedule(np.eye(1), name="centralized"),
                tgraphs.static_schedule(np.eye(1), name="centralized"))
    return _sched(jgraphs), _sched(tgraphs)


def _tspec(**kw):
    return TExecSpec(**dict(dict(resident=True, gossip="dense",
                                 device="cpu"), **kw))


def assert_sweeps_agree(want, got):
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(np.asarray(getattr(got.history, field)),
                                      np.asarray(getattr(want.history,
                                                         field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.history.objective, want.history.objective,
                               **OBJ_TOL, err_msg="objective")
    np.testing.assert_allclose(got.history.consensus, want.history.consensus,
                               **CONS_TOL, err_msg="consensus")
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  want.extras["wire_bytes"])


def _params(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


# ---------------------------------------------------------------------------
# every registered algorithm: batched and sequential against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALGORITHMS)
def test_batched_and_sequential_sweeps_match_jax(name):
    jbuild, tbuild = _builds(name)
    jsched, tsched = _schedules(name)
    grid = {"lam": [0.001, 0.1], "seed": [3, 7]}
    every = 2 if name == "inexact_prox_svrg" else 4
    want = jsweep.run_sweep(jbuild, grid, jsched,
                            JExecSpec(resident=True, gossip="dense"),
                            record_every=every)
    batched = tsweep.run_sweep(tbuild, grid, tsched, _tspec(),
                               record_every=every)
    sequential = tsweep.run_sweep(tbuild, grid, tsched, _tspec(),
                                  record_every=every, batched=False)
    assert batched.history.objective.shape[1] == 4
    assert [c["lam"] for c in batched.grid] == [c["lam"] for c in want.grid]
    assert_sweeps_agree(want, batched)
    assert_sweeps_agree(want, sequential)
    np.testing.assert_allclose(_params(batched.params), _params(want.params),
                               **OBJ_TOL)
    np.testing.assert_allclose(_params(sequential.params),
                               _params(batched.params), **OBJ_TOL)
    # one staging step and one history pull for the whole grid; the JAX
    # package also pulls the dataset to the host to sample from it, which
    # the port gathers on the device instead
    assert (batched.extras["transfers_h2d"],
            batched.extras["transfers_d2h"]) == (1, 1)
    assert want.extras["transfers_h2d"] == 1


@pytest.mark.parametrize("name", FUSED)
def test_fused_sweep_on_cpu_equals_plain_through_the_vmap_rule(name,
                                                               monkeypatch):
    """kernel="fused" on the CPU: each cell's fused step runs under the
    cell vmap, and the fused step's vmap rule hands all cells to ONE
    ``fused_step_cells_buf`` call a step (the plain version on the CPU)."""
    calls = []
    real = fused_ops.fused_step_cells_buf

    def counted(w, streams, *a, **kw):
        calls.append(tuple(streams[0].shape))
        return real(w, streams, *a, **kw)

    monkeypatch.setattr(fused_ops, "fused_step_cells_buf", counted)
    _, tbuild = _builds(name)
    grid = {"lam": [0.001, 0.1], "seed": [3, 7]}
    plain = tsweep.run_sweep(tbuild, grid, _sched(tgraphs), _tspec(),
                             record_every=4)
    fused = tsweep.run_sweep(tbuild, grid, _sched(tgraphs),
                             _tspec(kernel="fused"), record_every=4)
    assert_sweeps_agree(plain, fused)
    steps = int(plain.history.steps[-1, 0])
    assert len(calls) == steps and set(calls) == {(4, M, D)}


def test_batched_matches_sequential_host_path():
    """The sequential comparator can drive the host loop too."""
    _, tbuild = _builds("dspg")
    grid = {"seed": [0, 1, 2]}
    batched = tsweep.run_sweep(tbuild, grid, _sched(tgraphs), _tspec(),
                               record_every=8)
    host = tsweep.run_sweep(tbuild, grid, _sched(tgraphs),
                            _tspec(resident=False), record_every=8)
    assert_sweeps_agree(host, batched)
    assert host.extras["transfers_h2d"] > 3


def test_sweep_cell_slicing_matches_plain_run():
    """SweepResult.cell(i) is the RunResult a plain runner.run of that cell
    gives."""
    _, tbuild = _builds("dpsvrg")
    res = tsweep.run_sweep(tbuild, {"seed": [5, 9]}, _sched(tgraphs),
                           _tspec(), record_every=0)
    algo, problem = tbuild()
    ref = trunner.run(algo, problem, _sched(tgraphs),
                      TExecSpec(gossip="dense", device="cpu"), seed=9,
                      record_every=0)
    cell = res.cell(1)
    np.testing.assert_allclose(cell.history.objective, ref.history.objective,
                               **OBJ_TOL)
    np.testing.assert_array_equal(cell.history.epochs, ref.history.epochs)
    np.testing.assert_array_equal(cell.extras["wire_bytes"],
                                  ref.extras["wire_bytes"])
    np.testing.assert_allclose(cell.params.numpy(), ref.params.numpy(),
                               **OBJ_TOL)


@pytest.mark.parametrize("kernel", ["plain", "fused"])
def test_schedule_axis_zip_topology_grid(kernel):
    """Fig. 5's shape: the cells gossip over DIFFERENT time-varying
    schedules, zip-paired with per-cell seeds, in one batched dense run
    (one mixing matrix a cell), against the JAX package."""
    jbuild, tbuild = _builds("dpsvrg")
    grid_j = {"schedule": [_sched(jgraphs, 1, 1), _sched(jgraphs, 3, 3)],
              "seed": [1, 3]}
    grid_t = {"schedule": [_sched(tgraphs, 1, 1), _sched(tgraphs, 3, 3)],
              "seed": [1, 3]}
    want = jsweep.run_sweep(jbuild, grid_j,
                            JExecSpec(resident=True, gossip="dense"),
                            record_every=0, mode="zip")
    # the spec in the schedule slot is taken as exec=
    batched = tsweep.run_sweep(tbuild, grid_t, _tspec(kernel=kernel),
                               record_every=0, mode="zip")
    sequential = tsweep.run_sweep(tbuild, grid_t, _tspec(kernel=kernel),
                                  record_every=0, mode="zip", batched=False)
    assert_sweeps_agree(want, batched)
    assert_sweeps_agree(batched, sequential)
    # the two cells' wire bytes differ: their schedules do
    assert batched.extras["transfers_h2d"] == 1


def test_loopless_coin_flips_are_per_cell():
    """Each cell flips its own coins from its own seed: the cells' epoch
    columns (full gradients at their own flips) differ, and each equals a
    plain run of that cell on the host loop."""
    _, tbuild = _builds("loopless_dpsvrg")
    seeds = [0, 1, 2]
    res = tsweep.run_sweep(tbuild, {"seed": seeds}, _sched(tgraphs),
                           _tspec(), record_every=8)
    epochs = res.history.epochs
    assert len({tuple(epochs[:, i]) for i in range(3)}) > 1
    for i, s in enumerate(seeds):
        algo, problem = tbuild()
        host = trunner.run(algo, problem, _sched(tgraphs),
                           TExecSpec(gossip="dense", device="cpu"), seed=s,
                           record_every=8)
        np.testing.assert_array_equal(epochs[:, i], host.history.epochs)
        np.testing.assert_allclose(res.history.objective[:, i],
                                   host.history.objective, **OBJ_TOL)


def test_cell_values_reach_build_as_float32_tensors():
    """Inside the batched run every axis value reaches build() as a 0-d
    float32 tensor, and a prox weight that is a tensor keeps the float32
    threshold alpha * lam of the float path."""
    seen = []
    _, tbuild = _builds("dspg")

    def build(lam=0.01):
        seen.append(lam)
        return tbuild(lam)

    tsweep.run_sweep(build, {"lam": [0.001, 0.1]}, _sched(tgraphs),
                     _tspec(), record_every=10)
    assert isinstance(seen[0], float)
    traced = [v for v in seen if isinstance(v, torch.Tensor)]
    assert traced and all(v.dtype == torch.float32 for v in traced)
    alpha = torch.tensor(0.3, dtype=torch.float32)
    for lam in (0.001, 0.1, 1 / 3):
        lam_t = torch.tensor(lam, dtype=torch.float32)
        assert float(tprox.f32_product(alpha, lam_t)) == \
            tprox.f32_product(0.3, lam)
    assert tprox.l1(lam_t).name == "l1(cell)"


# ---------------------------------------------------------------------------
# errors, by name
# ---------------------------------------------------------------------------

def test_ragged_grid_structural_axis_rejected():
    def build(steps=20):
        p = talgorithm.Problem(torch_loss, tprox.l1(0.01), torch.zeros(M, D),
                               _tdata())
        return talgorithm.dspg_algorithm(
            p, talgorithm.DSPGHyperParams(alpha0=0.3), steps), p

    with pytest.raises(ValueError, match="ragged sweep grid.*num_steps"):
        tsweep.run_sweep(build, {"steps": [20, 40]}, _sched(tgraphs),
                         _tspec())


def test_ragged_grid_different_dataset_rejected():
    other = {k: v + 1.0 for k, v in _tdata().items()}

    def build(which=0):
        d = _tdata() if which == 0 else other
        p = talgorithm.Problem(torch_loss, tprox.l1(0.01), torch.zeros(M, D),
                               d)
        return talgorithm.dspg_algorithm(
            p, talgorithm.DSPGHyperParams(alpha0=0.3), 10), p

    with pytest.raises(ValueError, match="ragged sweep grid.*dataset"):
        tsweep.run_sweep(build, {"which": [0, 1]}, _sched(tgraphs), _tspec())


def test_ragged_grid_mixed_schedule_structure_needs_dense():
    """Banded wire formats with different offset unions cannot share one
    batched run; the error points at gossip='dense', on which the same
    grid batches."""
    _, tbuild = _builds("dspg")
    scheds = [tgraphs.static_schedule(np.eye(4), name="identity4"),
              _sched(tgraphs, 1, 2)]
    grid = {"schedule": scheds, "seed": [0, 1]}
    with pytest.raises(ValueError, match="dense"):
        tsweep.run_sweep(tbuild, grid, _tspec(gossip="banded"), mode="zip")
    res = tsweep.run_sweep(tbuild, grid, _tspec(), mode="zip",
                           record_every=5)
    assert res.history.objective.shape[1] == 2


def test_zip_mode_length_mismatch_rejected():
    _, tbuild = _builds("dspg")
    with pytest.raises(ValueError, match="zip-mode"):
        tsweep.run_sweep(tbuild, {"lam": [0.01, 0.1], "seed": [0]},
                         _sched(tgraphs), _tspec(), mode="zip")


def test_empty_grid_rejected():
    with pytest.raises(ValueError, match="empty sweep grid"):
        tsweep.run_sweep(_builds("dspg")[1], {}, _sched(tgraphs), _tspec())


def test_batched_sweep_needs_the_traced_transitions():
    _, tbuild = _builds("dpsvrg")

    def stripped(lam=0.01):
        algo, p = tbuild(lam)
        return dataclasses.replace(algo, outer_traced=None), p

    with pytest.raises(ValueError, match="outer_traced"):
        tsweep.run_sweep(stripped, {"seed": [0, 1]}, _sched(tgraphs),
                         _tspec())
    # sequentially, the host transitions serve
    res = tsweep.run_sweep(stripped, {"seed": [0, 1]}, _sched(tgraphs),
                           _tspec(), batched=False, record_every=0)
    assert res.history.objective.shape[1] == 2


@pytest.mark.parametrize("spec_kw", [dict(shard="cells"),
                                     dict(gossip="ppermute")])
def test_unported_sweep_paths_raise_by_name(spec_kw):
    """Cell-sharded sweeps and the ppermute transport run over a process
    group (tests/test_torch_mesh*.py); in a process without one they
    raise, naming how to start the ranks."""
    with pytest.raises(ValueError, match="spmd.spawn"):
        tsweep.run_sweep(_builds("dspg")[1], {"seed": [0]}, _sched(tgraphs),
                         _tspec(**spec_kw))


def test_batched_needs_resident():
    with pytest.raises(ValueError, match="resident"):
        tsweep.run_sweep(_builds("dspg")[1], {"seed": [0]}, _sched(tgraphs),
                         _tspec(resident=False), batched=True)


# ---------------------------------------------------------------------------
# O(1) transfers for the whole sweep
# ---------------------------------------------------------------------------

def test_sweep_transfer_ledger_is_o1():
    _, tbuild = _builds("dpsvrg")
    grid = {"lam": [0.001, 0.01, 0.03, 0.1], "seed": [0, 1]}
    batched = tsweep.run_sweep(tbuild, grid, _sched(tgraphs), _tspec(),
                               record_every=0)
    sequential = tsweep.run_sweep(tbuild, grid, _sched(tgraphs), _tspec(),
                                  record_every=0, batched=False)
    assert (batched.extras["transfers_h2d"],
            batched.extras["transfers_d2h"]) == (1, 1)
    # the per-cell sequential baseline pays per cell
    assert sequential.extras["transfers_h2d"] == len(batched.grid)
    assert sequential.extras["transfers_d2h"] == len(batched.grid)
    assert_sweeps_agree(sequential, batched)


def test_runner_reexports_the_sweep_driver():
    assert trunner.run_sweep is tsweep.run_sweep
    assert trunner.SweepResult is tsweep.SweepResult
