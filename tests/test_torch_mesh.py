"""Node-sharded runs of the port on 4 gloo ranks (``core.spmd``), on the
CPU: the ``ppermute`` transport (one node a rank) on the host loop,
``scan=True`` and the resident path, ``shard="nodes"`` (m / 4 rows a
rank) with the dense, banded and compressed transports, the kernel route
of a sharded svrg and sgd step and the scenario pipeline over
``ppermute``.

The ranks run in one group, spawned once for the module
(``_torch_mesh_workers.node_cases``; they import the port only), while
this process runs the same cases unsharded and the reference's
single-device runs, on the same numpy data.  The reference's own
multi-device runs fail on this tree (ROADMAP Queue 3), so they are no
oracle.  Each sharded history equals the port's unsharded run within 1e-5
(the reference's bound between its sharded and unsharded runs,
``tests/test_runner_shard.py``), the reference's dense single-device run
at the port's parity tolerances (objective rtol 1e-4 / atol 1e-6,
consensus rtol 1e-3 / atol 1e-6, ``tests/test_torch_sweep.py``), and its
wire bytes the reference's accounting (``_banded_wire_bytes``), exactly.
``compressed(ppermute)`` is held within 1e-4 (the reference's bound) and
its iterates at rtol 1e-4 / atol 1e-6.  Every rank returns the same
result, its ledger is (1, 1) on the resident path, and its wire is named.
The validation that needs no group runs here, before any spawn.
"""

import concurrent.futures
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_workers as w
from repro.core import algorithm as jalgorithm, gossip as jgossip, \
    graphs as jgraphs, prox as jprox, runner as jrunner, \
    transport as jtransport
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    runner as trunner, spmd, sweep as tsweep, transport as ttransport
from repro_torch.core.exec_spec import ExecSpec as TExecSpec

torch.set_num_threads(1)

CLOSE = 1e-5
OBJ_TOL = dict(rtol=1e-4, atol=1e-6)
CONS_TOL = dict(rtol=1e-3, atol=1e-6)
SPAWN_TIMEOUT = 180.0

PPERMUTE = ["ppermute_dpsvrg_host", "ppermute_dpsvrg_scan",
            "ppermute_dspg_matching", "ppermute_dspg_ring"]
RESIDENT_PPERMUTE = ["ppermute_resident_host_sampling",
                     "ppermute_resident_device_sampling"]
NODES = ["nodes_dense", "nodes_ppermute", "nodes_dense_m8",
         "nodes_banded_m8", "nodes_compressed_dense_m8"]
KERNEL = ["kernel_fused_ppermute", "kernel_fused_banded_m8",
          "kernel_fused_dspg_ppermute", "kernel_fused_dpg_banded_m8"]
# the cases held to the reference's dense single-device run
JAX_HELD = PPERMUTE + ["ppermute_resident_host_sampling", "nodes_dense",
                       "nodes_ppermute", "nodes_dense_m8"]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, from one group spawned in the background while
    the test process computes its own runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(spmd.spawn, w.node_cases, w.WORLD,
                             timeout=SPAWN_TIMEOUT)
        yield future
        future.result()


@pytest.fixture(scope="module")
def rank0(ranks):
    return ranks.result()[0]


def _jax_loss(wt, batch):
    logits = batch["features"] @ wt
    return jnp.mean(-batch["labels"] * logits + jnp.log1p(jnp.exp(logits)))


def _jax_problem(m):
    data = {k: jnp.asarray(v) for k, v in w.parts(m).items()}
    return jalgorithm.Problem(_jax_loss, jprox.l1(0.01),
                              jgossip.stack_tree(jnp.zeros(w.D), m), data)


def _jax_run(name):
    """The reference's dense single-device run of node case ``name``."""
    m, sched, algo, seed, every, kw, _ = w.NODE_CASES[name]
    problem = _jax_problem(m)
    spec = JExecSpec(resident=kw.get("resident", False), gossip="dense")
    return jrunner.run(w.factory(jalgorithm, algo, problem), problem,
                       w.schedule(jgraphs, sched, m), spec, seed=seed,
                       record_every=every)


@pytest.fixture(scope="module")
def unsharded(ranks):
    """The port's unsharded runs and the reference's dense ones, computed
    while the ranks run."""
    ports = {name: w.run_node_case(name, False) for name in w.NODE_CASES}
    refs = {name: _jax_run(name) for name in JAX_HELD}
    return ports, refs


def _assert_close(got: dict, want, bound=CLOSE):
    np.testing.assert_array_equal(got["history"]["steps"],
                                  want.history.steps)
    for col in ("objective", "consensus"):
        err = np.max(np.abs(got["history"][col]
                            - np.asarray(getattr(want.history, col))))
        assert err < bound, (col, err)
    params = want.params.numpy() if isinstance(want.params, torch.Tensor) \
        else np.asarray(want.params)
    assert np.max(np.abs(got["params"] - params)) < bound


def _assert_parity(got: dict, ref):
    for col, tol in (("objective", OBJ_TOL), ("consensus", CONS_TOL)):
        np.testing.assert_allclose(got["history"][col],
                                   np.asarray(getattr(ref.history, col)),
                                   **tol, err_msg=col)
    for col in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(got["history"][col],
                                      np.asarray(getattr(ref.history, col)),
                                      err_msg=col)


def test_every_rank_returns_the_same_result(ranks):
    results = ranks.result()
    for other in results[1:]:
        for name in w.NODE_CASES:
            for col, v in results[0][name]["history"].items():
                np.testing.assert_array_equal(other[name]["history"][col], v)
            np.testing.assert_array_equal(other[name]["params"],
                                          results[0][name]["params"])
            np.testing.assert_array_equal(
                other[name]["extras"]["wire_bytes"],
                results[0][name]["extras"]["wire_bytes"])


@pytest.mark.parametrize("name", PPERMUTE)
def test_ppermute_matches_dense(name, rank0, unsharded):
    """DPSVRG (k_max = 2) on the host loop and ``scan=True``, DSPG on the
    4-node matching schedule and on the b = 1 ring: the ppermute run equals
    the port's dense unsharded run and the reference's dense run."""
    ports, refs = unsharded
    _assert_close(rank0[name], ports[name])
    _assert_parity(rank0[name], refs[name])


def _reference_wire(name: str, backend: str) -> np.ndarray:
    """The reference's accounting of DSPG case ``name`` over ``backend``
    (one gossip round a step from slot 1): cumulative bytes at each
    record."""
    m, sched_name, algo, _, every, _, _ = w.NODE_CASES[name]
    sched = w.schedule(jgraphs, sched_name, m)
    meta = w.factory(jalgorithm, algo, _jax_problem(m)).meta
    pc = w.D
    offsets = jtransport.band_offset_union(sched, meta)
    total, out = 0, [0]
    for t in range(1, meta.num_steps + 1):
        if backend == "dense":
            total += m * (m - 1) * pc * jtransport.F32_BYTES
        else:
            coeffs = jgossip.bands_for_phi(sched.consensus_rounds(t, 1),
                                           offsets)
            total += jtransport._banded_wire_bytes(offsets, coeffs, m, pc)
        if t % every == 0:
            out.append(total)
    return np.array(out, np.int64)


@pytest.mark.parametrize("name", ["ppermute_dspg_matching",
                                  "ppermute_dspg_ring"])
def test_ppermute_wire_is_the_references_and_below_dense(name, rank0,
                                                         unsharded):
    ports, _ = unsharded
    got = rank0[name]["extras"]["wire_bytes"]
    dense = ports[name].extras["wire_bytes"]
    np.testing.assert_array_equal(got, _reference_wire(name, "banded"))
    np.testing.assert_array_equal(dense, _reference_wire(name, "dense"))
    assert got[-1] < dense[-1]


def test_auto_picks_ppermute_with_a_mesh(rank0):
    """Judged on DSPG's meta (one round a step), whose m = 4 matchings keep
    the offsets {0, 1, 3}: with a node mesh "ppermute", without one
    "banded", as the reference picks."""
    assert rank0["auto"] == {"with_mesh": "ppermute",
                             "without_mesh": "banded"}
    sched = w.schedule(tgraphs, "matching", 4)
    jsched = w.schedule(jgraphs, "matching", 4)
    tmeta = w.factory(talgorithm, "dspg", w.make_problem(4)).meta
    jmeta = w.factory(jalgorithm, "dspg", _jax_problem(4)).meta
    assert ttransport.select_backend_name(sched, tmeta) == \
        jtransport.select_backend_name(jsched, jmeta) == "banded"


@pytest.mark.parametrize("name", RESIDENT_PPERMUTE)
def test_resident_ppermute(name, rank0, unsharded):
    """Resident ppermute with host and device sampling: each rank draws its
    rows of the same streams, so the run equals the unsharded one."""
    ports, refs = unsharded
    got = rank0[name]
    _assert_close(got, ports[name])
    if name in refs:
        _assert_parity(got, refs[name])
    assert (got["extras"]["transfers_h2d"],
            got["extras"]["transfers_d2h"]) == (1, 1)
    assert got["extras"]["graphs_built"] == 0


@pytest.mark.parametrize("name", NODES)
def test_shard_nodes_matches_unsharded(name, rank0, unsharded):
    """shard="nodes" over dense, ppermute and banded gossip and over
    compressed(dense), with one node a rank (m = 4) and two (m = 8): the
    history equals the unsharded run's, the wire its accounting, and the
    ledger stays (1, 1) a rank."""
    ports, refs = unsharded
    got = rank0[name]
    _assert_close(got, ports[name])
    if name in refs:
        _assert_parity(got, refs[name])
    if "ppermute" not in name:
        np.testing.assert_array_equal(got["extras"]["wire_bytes"],
                                      ports[name].extras["wire_bytes"])
    assert (got["extras"]["transfers_h2d"],
            got["extras"]["transfers_d2h"]) == (1, 1)


@pytest.mark.parametrize("name", ["nodes_compressed_ppermute",
                                  "nodes_compressed_ppermute_int8"])
def test_compressed_ppermute(name, rank0, unsharded):
    """compressed(ppermute) quantizes each rank's row before the wire: 12
    steps within 1e-4 of the unsharded compressed run, iterates at rtol
    1e-4 / atol 1e-6, and the wire at exactly bits / 32 of the
    uncompressed banded accounting."""
    ports, _ = unsharded
    got = rank0[name]
    _assert_close(got, ports[name], bound=1e-4)
    np.testing.assert_allclose(got["params"], ports[name].params.numpy(),
                               rtol=1e-4, atol=1e-6)
    bits = w.NODE_CASES[name][5]["gossip"][2]
    m, sched, algo, seed, every, _, _ = w.NODE_CASES[name]
    problem = w.make_problem(m)
    banded = trunner.run(w.factory(talgorithm, algo, problem),
                         problem, w.schedule(tgraphs, sched, m),
                         TExecSpec(resident=True, gossip="banded",
                                   device="cpu"), seed=seed,
                         record_every=every)
    np.testing.assert_array_equal(got["extras"]["wire_bytes"] * 32,
                                  banded.extras["wire_bytes"] * bits)


def test_compressed_link_maps_sum_exactly(rank0):
    assert rank0["link_sums_exact"] == {4: True, 3: True}


@pytest.mark.parametrize("name", KERNEL)
def test_sharded_kernel_route_matches_the_plain_step(name, rank0,
                                                     unsharded):
    """kernel="fused" on a node-sharded step: the svrg rule (DPSVRG over
    ppermute, DVR over banded at two rows a rank) through svrg_step, the
    wire, then mix_prox row by row; the sgd rule (DSPG over ppermute, DPG
    over banded at two rows a rank) through q = x - alpha g, the wire, then mix_prox (the kernels'
    plain versions on the CPU); each equal to the unsharded plain run."""
    ports, _ = unsharded
    _assert_close(rank0[name], ports[name])


def test_scenario_pipeline_rides_ppermute(rank0, unsharded):
    """A stale scenario (delay 1) over the ppermute inner transport equals
    the same scenario over banded gossip on the whole stack."""
    ports, _ = unsharded
    _assert_close(rank0["scenario_ppermute"], ports["scenario_ppermute"])
    np.testing.assert_array_equal(
        rank0["scenario_ppermute"]["extras"]["wire_bytes"],
        ports["scenario_ppermute"].extras["wire_bytes"])


def test_every_sharded_run_names_its_wire_and_runs_eagerly(rank0):
    for name in w.NODE_CASES:
        extras = rank0[name]["extras"]
        assert extras["wire"] == "gloo", name
        assert extras.get("graphs_built", 0) == 0, name


def test_group_refusals_name_their_cause(rank0):
    errors = rank0["errors"]
    assert "divisible" in errors["nodes_divisibility"]
    assert "m=8" in errors["ppermute_world"]
    assert "spmd.local_problem" in errors["whole_problem"]
    assert "split evenly" in errors["cells_divisibility"]
    assert "batched=False" in errors["batched_ppermute"]
    assert "l1 prox" in errors["fused_sgd"]
    assert "stateless" in errors["fused_compressed"]


# ---------------------------------------------------------------------------
# validation that needs no group, in this process
# ---------------------------------------------------------------------------

def _tiny(m=4):
    problem = w.make_problem(m)
    return w.factory(talgorithm, "dspg", problem), problem


def test_ppermute_without_a_group_names_spawn():
    algo, problem = _tiny()
    with pytest.raises(ValueError, match="spmd.spawn"):
        trunner.run(algo, problem, w.schedule(tgraphs, "ring", 4),
                    TExecSpec(gossip="ppermute", device="cpu"))


def test_shard_nodes_without_a_group_names_spawn():
    algo, problem = _tiny()
    with pytest.raises(ValueError, match="spmd.spawn"):
        trunner.run(algo, problem, w.schedule(tgraphs, "ring", 4),
                    TExecSpec(resident=True, gossip="dense", shard="nodes",
                              device="cpu"))


def test_nccl_over_fewer_cards_than_ranks_raises_by_name():
    with pytest.raises(ValueError, match="NCCL needs a card a rank"):
        spmd.spawn(w.node_cases, 64, backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="'gloo' or 'nccl'"):
        spmd.spawn(w.node_cases, 2, backend="mpi")


def test_shard_cells_on_run_points_at_run_sweep():
    algo, problem = _tiny()
    with pytest.raises(ValueError, match="run_sweep"):
        trunner.run(algo, problem, w.schedule(tgraphs, "ring", 4),
                    TExecSpec(resident=True, shard="cells", device="cpu"))


def test_shard_nodes_on_sweep_points_at_run():
    with pytest.raises(ValueError, match="runner.run"):
        tsweep.run_sweep(_tiny, {"seed": [0, 1]},
                         w.schedule(tgraphs, "ring", 4),
                         TExecSpec(resident=True, shard="nodes",
                                   device="cpu"))


def test_shard_cells_refuses_a_node_exchanging_transport():
    with pytest.raises(ValueError, match="shard='nodes'"):
        tsweep.run_sweep(_tiny, {"seed": [0]},
                         w.schedule(tgraphs, "ring", 4),
                         TExecSpec(resident=True, gossip="ppermute",
                                   shard="cells", device="cpu"))


@pytest.mark.parametrize("kw,match", [
    (dict(shard="nodes"), "requires resident=True"),
    (dict(shard="cells"), "requires resident=True"),
    (dict(resident=True, shard="rows"), "shard must be"),
])
def test_exec_spec_validates_shard(kw, match):
    with pytest.raises(ValueError, match=match):
        TExecSpec(device="cpu", **kw)


def test_a_failing_rank_fails_spawn_at_once_with_its_traceback():
    """The other rank waits in a barrier for the failed one: spawn raises
    the failure's traceback without waiting for the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spmd.spawn(w.fail_on_rank, 2, args=(1,), timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < 60


def test_a_group_past_its_timeout_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done after 5 s"):
        spmd.spawn(w.sleep_for, 2, args=(120.0,), timeout=5.0)
    assert time.monotonic() - t0 < 30


def test_a_rank_that_fails_to_start_reports_its_own_error(monkeypatch):
    """When a rank's process cannot start, the ones before it are killed
    and the start's error reaches the caller: only started processes are
    joined (joining one that never started raises an AssertionError that
    would hide it)."""
    real = spmd.multiprocessing.get_context("spawn")
    made = []

    def refuse():
        raise OSError("no process for rank 1")

    def process(*args, **kw):
        p = real.Process(*args, **kw)
        made.append(p)
        if len(made) == 2:
            p.start = refuse
        return p

    monkeypatch.setattr(spmd.multiprocessing, "get_context",
                        lambda method: types.SimpleNamespace(
                            Process=process, Queue=real.Queue))
    t0 = time.monotonic()
    with pytest.raises(OSError, match="no process for rank 1"):
        spmd.spawn(w.sleep_for, 3, args=(120.0,), timeout=30.0)
    assert len(made) == 3 and not made[0].is_alive()
    assert time.monotonic() - t0 < 30


class _StubMesh:
    """Stands in for a DeviceMesh where only its dims' names and sizes are
    read: the validation below fails before any exchange."""

    def __init__(self, **dims):
        self.mesh_dim_names = tuple(dims)
        self.mesh = np.empty(tuple(dims.values()))


def test_divisibility_and_mesh_shape_refusals_before_any_exchange():
    algo, problem = _tiny()
    ring = w.schedule(tgraphs, "ring", 4)
    with pytest.raises(ValueError, match="no dim whose size divides m=4"):
        trunner.run(algo, problem, ring,
                    TExecSpec(resident=True, gossip="dense", shard="nodes",
                              mesh=_StubMesh(nodes=3), device="cpu"))
    with pytest.raises(ValueError, match="no dim of size m=4"):
        trunner.run(algo, problem, ring,
                    TExecSpec(gossip="ppermute", mesh=_StubMesh(nodes=3),
                              device="cpu"))
    cells = TExecSpec(resident=True, gossip="dense", shard="cells",
                      device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        tsweep.run_sweep(_tiny, {"seed": [0, 1, 2]}, ring,
                         cells.replace(mesh=_StubMesh(cells=4)))
    with pytest.raises(ValueError, match="named 'cells'"):
        tsweep.run_sweep(_tiny, {"seed": [0, 1, 2, 3]}, ring,
                         cells.replace(mesh=_StubMesh(nodes=4)))
