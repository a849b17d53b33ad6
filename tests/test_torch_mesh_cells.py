"""Cell-sharded sweeps of the port (``ExecSpec(shard="cells")``) on 4 gloo
ranks (``core.spmd``), on the CPU.

One group of ranks, spawned once for the module
(``_torch_mesh_workers.cell_cases``; the ranks import the port only), runs
every registered algorithm's 4-seed grid on the reference's problem
(``tests/test_runner_shard.py``: m = 4 on the b = 1 ring, m = 1 for
Algorithm 2), one cell a rank, then a topology grid (one schedule a cell)
over an explicit ``("cells",)`` mesh and ``run_matrix`` with
``shard="cells"``.  This process runs the same grids unsharded in the port
and in the reference.  The sharded histories equal the port's unsharded
batched sweep within 1e-5 (the reference's own bound between sharded and
unsharded) and the reference's unsharded sweep at the port's parity
tolerances (objective rtol 1e-4 / atol 1e-6, consensus rtol 1e-3 / atol
1e-6); the counting columns and the wire bytes exactly, the ledger (1, 1)
a rank.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_workers as w
from repro.core import algorithm as jalgorithm, gossip as jgossip, \
    graphs as jgraphs, inexact as jinexact, prox as jprox, sweep as jsweep
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro_torch.core import spmd, sweep as tsweep
from repro_torch.core.exec_spec import ExecSpec as TExecSpec

torch.set_num_threads(1)

CLOSE = 1e-5
OBJ_TOL = dict(rtol=1e-4, atol=1e-6)
CONS_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def ranks():
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(spmd.spawn, w.cell_cases, w.WORLD,
                             timeout=180.0)
        yield future
        future.result()


@pytest.fixture(scope="module")
def rank0(ranks):
    return ranks.result()[0]


def _jax_loss(wt, batch):
    logits = batch["features"] @ wt
    return jnp.mean(-batch["labels"] * logits + jnp.log1p(jnp.exp(logits)))


def _jax_build(name):
    m = 1 if name == "inexact_prox_svrg" else 4
    data = {k: jnp.asarray(v) for k, v in w.parts(m).items()}
    problem = jalgorithm.Problem(_jax_loss, jprox.l1(0.01),
                                 jgossip.stack_tree(jnp.zeros(w.D), m), data)

    def build():
        return w.factory(jalgorithm, name, problem, jinexact), problem

    sched = w.schedule(jgraphs, "centralized" if m == 1 else "ring", m)
    return build, sched


@pytest.fixture(scope="module")
def unsharded(ranks):
    """The port's and the reference's unsharded sweeps, computed while the
    ranks run."""
    spec = TExecSpec(resident=True, gossip="dense", device="cpu")
    ports, refs = {}, {}
    for name in w.CELL_ALGORITHMS:
        build, sched = w.cell_build(name)
        ports[name] = tsweep.run_sweep(build, w.CELL_GRID, sched, spec,
                                       record_every=4)
        jbuild, jsched = _jax_build(name)
        refs[name] = jsweep.run_sweep(
            jbuild, w.CELL_GRID, jsched,
            JExecSpec(resident=True, gossip="dense"), record_every=4)
    ports["topology"] = w.run_topology_grid()
    jdata = {k: jnp.asarray(v) for k, v in w.parts(4).items()}
    jproblem = jalgorithm.Problem(_jax_loss, jprox.l1(0.01),
                                  jgossip.stack_tree(jnp.zeros(w.D), 4),
                                  jdata)
    refs["topology"] = jsweep.run_sweep(
        lambda: (w.factory(jalgorithm, "loopless_dpsvrg", jproblem),
                 jproblem),
        {"schedule": w.topology_scheds(jgraphs), "seed": [0, 1, 2, 3]},
        exec=JExecSpec(resident=True, gossip="dense"), record_every=4,
        mode="zip")
    return ports, refs


def _assert_cells(got: dict, port, ref):
    for col in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(got["history"][col],
                                      np.asarray(getattr(port.history, col)))
        np.testing.assert_array_equal(got["history"][col],
                                      np.asarray(getattr(ref.history, col)))
    for col, tol in (("objective", OBJ_TOL), ("consensus", CONS_TOL)):
        err = np.max(np.abs(got["history"][col]
                            - getattr(port.history, col)))
        assert err < CLOSE, (col, err)
        np.testing.assert_allclose(got["history"][col],
                                   np.asarray(getattr(ref.history, col)),
                                   **tol, err_msg=col)
    assert np.max(np.abs(got["params"] - port.params.numpy())) < CLOSE
    np.testing.assert_array_equal(got["extras"]["wire_bytes"],
                                  port.extras["wire_bytes"])
    np.testing.assert_array_equal(got["extras"]["wire_bytes"],
                                  np.asarray(ref.extras["wire_bytes"]))
    assert (got["extras"]["transfers_h2d"],
            got["extras"]["transfers_d2h"]) == (1, 1)
    assert got["extras"]["wire"] == "gloo"


@pytest.mark.parametrize("name", w.CELL_ALGORITHMS)
def test_shard_cells_matches_unsharded(name, rank0, unsharded):
    ports, refs = unsharded
    _assert_cells(rank0[name], ports[name], refs[name])


def test_shard_cells_topology_grid_over_an_explicit_mesh(rank0, unsharded):
    """Cells over four schedules (b = 1, 2, 1, 3) zipped with four seeds,
    split over an explicit ``("cells",)`` DeviceMesh."""
    ports, refs = unsharded
    _assert_cells(rank0["topology"], ports["topology"], refs["topology"])


def test_every_rank_gathers_the_whole_grid(ranks):
    results = ranks.result()
    for other in results[1:]:
        for name in w.CELL_ALGORITHMS + ["topology"]:
            np.testing.assert_array_equal(
                other[name]["history"]["objective"],
                results[0][name]["history"]["objective"])
            np.testing.assert_array_equal(other[name]["params"],
                                          results[0][name]["params"])
        assert other["matrix"] == results[0]["matrix"]


def test_run_matrix_shard_cells_equals_its_unsharded_rows(rank0):
    """run_matrix with shard="cells": each program's eight cells (two
    topologies x two failure models x two seeds) split over the ranks; the
    rows equal the unsharded matrix's and every program's ledger is (1, 1)
    a rank."""
    rows, ledgers = rank0["matrix"]
    want_rows, want_ledgers = w.run_matrix(None)
    assert len(rows) == len(want_rows) == 16
    for got, want in zip(rows, want_rows):
        assert got[:5] == want[:5] and got[6:] == want[6:]
        assert abs(got[5] - want[5]) < CLOSE
    assert ledgers == want_ledgers == [(1, 1), (1, 1)]
