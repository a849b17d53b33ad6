"""The port's scenario matrix (``repro_torch.scenarios.run_matrix``), its
benchmark (``benchmarks/pt_beyond_noniid.py`` through ``pt_run --only
beyond``) and the two scenario examples, against the JAX package's, on the
CPU.

* ``run_matrix`` on a small grid (two topologies x {none, link failures,
  stale gossip, stragglers + churn} x {f32, int8} x three algorithms x two
  seeds): every row against the reference's ``run_matrix`` (objective
  within rtol 1e-4; wire bytes, gossip rounds and steps exactly), every
  program's final iterates against the reference's and its sequential
  runs' (rtol 1e-4, atol 1e-6), each int8 program's iterates outside
  that tolerance of its f32 twin's (with error feedback the objectives of
  int8 and f32 rows differ by less than their tolerance, so only the
  iterates show a wrong payload format), one batched program per
  (algorithm, compression, transport spec) with the ledger (1, 1), batched
  rows equal to sequential ones, ``pareto_frontier`` and ``format_table``
  equal to the reference's on the same rows;
* zero-intensity rows bitwise the unwrapped batched sweep's; quantized rows
  charged a quarter; ``mesh`` / ``shard`` refused by name; the CUDA default
  refused without a card;
* ``pt_run --only beyond --scale 0.02 --device cpu`` against the
  reference's ``benchmarks.run --only beyond``: the same CSV rows, minimum
  wire bytes and frontier, every matrix row's wire bytes exactly, F(x*)
  within rtol 1e-5, and the f32 rows' objectives and gaps within rtol
  1e-4.  The int8 rows' objectives are held within rtol 1e-3: after about
  60 of the 120 steps, a float32 rounding difference between the packages
  (last-ulp, from other summation orders) puts one value on the other side
  of an int8 rounding boundary, and from there the two runs differ by
  whole quantization steps (measured: at most 1.4e-4 relative in the
  objective, 6.4e-4 in the gap, where the f32 rows agree to 2e-6).  That
  bound holds the drift only: an int8 row's objective lies within 2e-6 to
  1.6e-4 of its f32 twin's, so no objective tolerance sees a wrong payload
  format; the 12-step iterate test above does;
* the two torch examples with ``--device cpu`` at a small size.
"""

import functools
import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro import scenarios as jsc  # noqa: E402
from repro.core import algorithm as jalgorithm, graphs as jgraphs, \
    prox as jprox  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    prox as tprox, sweep as tsweep  # noqa: E402
from repro_torch.core.exec_spec import ExecSpec as TExecSpec  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, D = 4, 128, 12
OBJ_RTOL = 1e-4
# int8 rows of the 120-step beyond matrix: see the module docstring
INT8_OBJ_RTOL = 1e-3


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


def _inputs(pkg):
    """(problem, topologies, failures, algorithms) of one package."""
    sc, graphs, algorithm, prox = pkg
    x0 = np.zeros((M, D), np.float32)
    if sc is jsc:
        problem = algorithm.Problem(
            jax_loss, prox.l1(0.01), jnp.asarray(x0),
            {k: jnp.asarray(v) for k, v in _parts().items()})
    else:
        problem = algorithm.Problem(torch_loss, prox.l1(0.01),
                                    params_from_numpy(x0, "cpu"),
                                    params_from_numpy(_parts(), "cpu"))
    topologies = {
        "ring": graphs.static_schedule(graphs.ring_matrix(M), name="ring4"),
        "bconn": graphs.b_connected_ring_schedule(M, b=2, seed=1),
    }
    failures = {
        "none": [],
        "links": [sc.LinkFailures(0.3)],
        "stale": [sc.StaleGossip(1)],
        "strag+churn": [sc.Stragglers(2.0), sc.NodeChurn(0.3, dwell=3)],
    }
    algorithms = {
        "loopless": lambda p: algorithm.loopless_dpsvrg_algorithm(
            p, 0.3, 12, snapshot_prob=0.2),
        "dvr": lambda p: algorithm.dvr_algorithm(p, 0.3, 12, rho=0.7,
                                                 snapshot_prob=0.2),
        "gt_svrg": lambda p: algorithm.gt_svrg_algorithm(p, 0.1, 2, 6),
    }
    return problem, topologies, failures, algorithms


JPKG = (jsc, jgraphs, jalgorithm, jprox)
TPKG = (tsc, tgraphs, talgorithm, tprox)
GRID = dict(compressions=(None, 8), seeds=(0, 1), record_every=6,
            scenario_seed=2)


@functools.lru_cache(maxsize=None)
def _matrices():
    want = jsc.run_matrix(*_inputs(JPKG), **GRID)
    got = tsc.run_matrix(*_inputs(TPKG), **GRID, device="cpu")
    seq = tsc.run_matrix(*_inputs(TPKG), **GRID, device="cpu", batched=False)
    return want, got, seq


def _assert_rows_match(want_rows, got_rows, rtol=OBJ_RTOL):
    assert len(got_rows) == len(want_rows)
    for w, g in zip(want_rows, got_rows):
        assert g[:5] == w[:5]
        assert (g.wire_bytes, g.comm_rounds, g.steps) == \
            (w.wire_bytes, w.comm_rounds, w.steps), (w, g)
        np.testing.assert_allclose(g.objective, w.objective, rtol=rtol,
                                   err_msg=str(w[:5]))


def test_run_matrix_rows_match_reference():
    want, got, _ = _matrices()
    assert len(got.rows) == 2 * 4 * 2 * 3 * 2
    _assert_rows_match(want.rows, got.rows)
    assert [(g["algorithm"], g["compression"], g["transport"], g["cells"])
            for g in got.groups] == \
        [(g["algorithm"], g["compression"], g["transport"], g["cells"])
         for g in want.groups]


def _over_tolerance(got, want, rtol=OBJ_RTOL, atol=1e-6) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 exactly where
    ``assert_allclose(got, want, rtol=rtol, atol=atol)`` fails."""
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def test_run_matrix_iterates_match_reference_and_tell_int8_from_f32():
    want, got, seq = _matrices()
    xs = {}
    for w, g, s in zip(want.groups, got.groups, seq.groups):
        key = (g["algorithm"], g["compression"],
               tuple(g["transport"].values()))
        x = g["sweep"].params.numpy()
        np.testing.assert_allclose(x, np.asarray(w["sweep"].params),
                                   rtol=OBJ_RTOL, atol=1e-6,
                                   err_msg=f"{key} against the reference")
        np.testing.assert_allclose(x, s["sweep"].params.numpy(),
                                   rtol=OBJ_RTOL, atol=1e-6,
                                   err_msg=f"{key} batched vs sequential")
        xs[key] = x
    # the upper reading: f32 payloads in an int8 program's place would
    # fail the iterate check above (the objectives cannot tell them apart)
    for (algo, comp, transport), x in xs.items():
        if comp == "int8":
            assert _over_tolerance(x, xs[(algo, "f32", transport)]) > 1.0, \
                (algo, transport)


def test_run_matrix_one_program_a_group_with_the_ledger_one_one():
    _, got, _ = _matrices()
    # (algorithm) x (compression) x (transport spec: none, stale,
    # stragglers)
    assert len(got.groups) == 3 * 2 * 3
    for grp in got.groups:
        assert (grp["transfers_h2d"], grp["transfers_d2h"]) == (1, 1), grp
        assert grp["sweep"].history.objective.shape[1] == grp["cells"]


def test_run_matrix_batched_rows_equal_sequential_rows():
    _, got, seq = _matrices()
    for b, s in zip(got.rows, seq.rows):
        assert b[:5] == s[:5]
        assert (b.wire_bytes, b.comm_rounds, b.steps) == \
            (s.wire_bytes, s.comm_rounds, s.steps)
        np.testing.assert_allclose(b.objective, s.objective, rtol=OBJ_RTOL,
                                   err_msg=str(b[:5]))


def test_pareto_frontier_and_format_table_equal_the_reference():
    want, got, _ = _matrices()
    as_ref = [jsc.MatrixRow(*r) for r in got.rows]
    assert [tuple(r) for r in tsc.pareto_frontier(got.rows)] == \
        [tuple(r) for r in jsc.pareto_frontier(as_ref)]
    for frontier in (True, False):
        assert tsc.format_table(got.rows, frontier) == \
            jsc.format_table(as_ref, frontier)
    # the two runs' frontiers pick the same cells
    assert [r[:5] for r in tsc.pareto_frontier(got.rows)] == \
        [r[:5] for r in jsc.pareto_frontier(want.rows)]
    table = tsc.format_table(got.rows)
    assert "*" in table and len(table.splitlines()) == 2 + len(got.rows)
    assert got.row("ring", "links", "int8", "dvr", 1) is got.rows[
        [r[:5] for r in got.rows].index(("ring", "links", "int8", "dvr", 1))]
    with pytest.raises(KeyError):
        got.row("ring", "links", "int4", "dvr", 1)


def test_matrix_zero_intensity_rows_match_unwrapped_sweep_bitwise():
    problem, topologies, _, algorithms = _inputs(TPKG)
    res = tsc.run_matrix(problem, topologies, {"none": []},
                         {"loopless": algorithms["loopless"]}, seeds=(0, 1),
                         record_every=6, device="cpu")

    def build():
        return algorithms["loopless"](problem), problem

    ref = tsweep.run_sweep(
        build, {"schedule": list(topologies.values()), "seed": [0, 1]},
        TExecSpec(resident=True, gossip="dense", device="cpu"),
        record_every=6)
    np.testing.assert_array_equal(res.groups[0]["sweep"].history.objective,
                                  ref.history.objective)
    for i, row in enumerate(res.rows):
        assert row.objective == float(ref.history.objective[-1, i])


def test_matrix_charges_quantized_rows_less():
    problem, topologies, _, algorithms = _inputs(TPKG)
    res = tsc.run_matrix(problem, {"ring": topologies["ring"]},
                         {"none": []}, algorithms, compressions=(None, 8),
                         seeds=(0,), record_every=6, device="cpu")
    for algo in algorithms:
        f32 = res.row("ring", "none", "f32", algo, 0)
        int8 = res.row("ring", "none", "int8", algo, 0)
        assert int8.wire_bytes * 4 == f32.wire_bytes


@pytest.mark.parametrize("kw,match", [(dict(shard="cells"), "spmd.spawn"),
                                      (dict(shard="nodes"), "runner.run")])
def test_matrix_refuses_mesh_and_shard_by_name(kw, match):
    """shard="cells" splits each program's cells over a process group
    (tests/test_torch_mesh_cells.py) and raises without one;
    shard="nodes" belongs to runner.run."""
    problem, topologies, failures, algorithms = _inputs(TPKG)
    with pytest.raises(ValueError, match=match):
        tsc.run_matrix(problem, topologies, failures, algorithms,
                       device="cpu", **kw)


def test_matrix_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    problem, topologies, failures, algorithms = _inputs(TPKG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.run_matrix(problem, topologies, failures, algorithms)


# ---------------------------------------------------------------------------
# benchmarks: pt_run --only beyond against the reference's run --only beyond
# ---------------------------------------------------------------------------

CSV_GAP = re.compile(r"gap_([A-Za-z_]+)=(-?[0-9.]+)")


def _capture(monkeypatch, out: dict, module, names):
    """Wrap ``module``'s functions ``names`` to keep their last results in
    ``out``."""
    for name in names:
        fn = getattr(module, name)

        def wrapper(*args, _fn=fn, _name=name, **kw):
            out[_name] = _fn(*args, **kw)
            return out[_name]

        monkeypatch.setattr(module, name, wrapper)


def _csv(main, argv, monkeypatch=None):
    buf = io.StringIO()
    with redirect_stdout(buf):
        if monkeypatch is not None:          # the reference reads sys.argv
            monkeypatch.setattr(sys, "argv", ["run.py"] + argv)
            main()
        else:
            main(argv)
    return [line.split(",", 2) for line in buf.getvalue().splitlines()[1:]]


def test_pt_run_beyond_matches_reference(monkeypatch):
    from benchmarks import common as jcommon, pt_common, pt_run
    from benchmarks import run as jrun
    argv = ["--only", "beyond", "--scale", "0.02"]
    jcap, tcap = {}, {}
    _capture(monkeypatch, jcap, jsc, ["run_matrix"])
    _capture(monkeypatch, jcap, jcommon, ["f_star"])
    want = _csv(jrun.main, argv, monkeypatch)
    _capture(monkeypatch, tcap, tsc, ["run_matrix"])
    _capture(monkeypatch, tcap, pt_common, ["f_star"])
    got = _csv(pt_run.main, argv + ["--device", "cpu"])

    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == 9
    for w, g in zip(want, got):
        if w[0] == "beyond/frontier":
            assert g[2] == w[2]
            continue
        assert g[2].split("min_wire=")[1] == w[2].split("min_wire=")[1]
        names = [k for k, _ in CSV_GAP.findall(g[2])]
        assert names == [k for k, _ in CSV_GAP.findall(w[2])]
        assert names == ["dvr", "gt_svrg", "loopless_dpsvrg"]

    fs_want, fs_got = jcap["f_star"], tcap["f_star"]
    np.testing.assert_allclose(fs_got, fs_want, rtol=1e-5)
    want_rows, got_rows = jcap["run_matrix"].rows, tcap["run_matrix"].rows
    assert len(got_rows) == 48
    assert [len(g["sweep"].grid) for g in tcap["run_matrix"].groups] == \
        [len(g["sweep"].grid) for g in jcap["run_matrix"].groups]
    for w, g in zip(want_rows, got_rows):
        assert g[:5] == w[:5]
        assert (g.wire_bytes, g.comm_rounds, g.steps) == \
            (w.wire_bytes, w.comm_rounds, w.steps)
        rtol = OBJ_RTOL if w.compression == "f32" else INT8_OBJ_RTOL
        np.testing.assert_allclose(g.objective, w.objective, rtol=rtol,
                                   err_msg=str(w[:5]))
        if w.compression == "f32":
            np.testing.assert_allclose(g.objective - fs_got,
                                       w.objective - fs_want, rtol=OBJ_RTOL,
                                       err_msg=f"gap {w[:5]}")
    for grp in tcap["run_matrix"].groups:
        assert (grp["transfers_h2d"], grp["transfers_d2h"]) == (1, 1)


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _example(name, *args) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), "--device",
         "cpu", *args], capture_output=True, text=True, env=env,
        check=True).stdout


def test_robustness_frontier_example_runs_on_cpu():
    out = _example("torch_robustness_frontier.py", "--steps", "20")
    assert "frontier:" in out and "of 60 cells" in out
    assert out.count("transfers h2d=1 d2h=1") == 18


def test_timevarying_topology_example_runs_on_cpu():
    out = _example("torch_timevarying_topology.py", "--num-outer", "3",
                   "--steps", "20")
    assert "static-ring+links0.3@7" in out
    assert "stale+straggler gossip (resident)" in out
    assert "banded-gossip resident on tdma-matchings" in out
