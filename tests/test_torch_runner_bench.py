"""``benchmarks/pt_runner_bench.py`` on the CPU at a small size: every row
of the port's runner bench is produced (host loop, scan, resident with
host and device sampling for DSPG and DPSVRG; the dense, banded and
compressed transports; ppermute and the sharded rows on 4 gloo ranks; the
per-round graph count; the LM trainer), its assertions (ledgers,
histories held to each other, the device-sampled envelope) pass, no row is
left out, and ``pt_run --only runner`` drives it.  The rows across ranks
run once for the module (one spawned group) and serve every test."""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import pt_run, pt_runner_bench  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    """The rows across ranks at the small size, from one group of ranks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_runner_bench, "ITERS", 1)
        return pt_runner_bench.mesh_stats(0.02, "cpu")


@pytest.fixture
def small(monkeypatch, mesh):
    monkeypatch.setattr(pt_runner_bench, "mesh_stats",
                        lambda scale, device: mesh)
    monkeypatch.setattr(pt_runner_bench, "DSPG_STEPS", 200)
    monkeypatch.setattr(pt_runner_bench, "DSPG_RECORD", 50)
    monkeypatch.setattr(pt_runner_bench, "TRAIN_STEPS", 30)
    monkeypatch.setattr(pt_runner_bench, "ITERS", 1)


def test_pt_run_drives_the_runner_bench(small, capsys):
    pt_run.main(["--only", "runner", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    names = [line.split(",")[0] for line in lines[1:]]
    for algo in ("dspg", "dpsvrg"):
        for path in pt_runner_bench.PATHS:
            assert f"runner/{algo}_{path}" in names
    for name in ("dense", "banded", "compressed", "ppermute"):
        assert f"runner/backend_{name}" in names
    assert "runner/dpsvrg_scan_record_every_0" in names
    assert "trainer/lm_resident_device_sampling_30steps" in names
    assert "runner/shard_cells_sweep8" in names
    assert "runner/shard_nodes_dspg32" in names
    assert not [line for line in lines if "not run" in line]


def test_json_section_holds_ledgers_and_wire_bytes(small, tmp_path):
    path = str(tmp_path / "BENCH_torch.json")
    with open(path, "w") as f:
        json.dump({"kernels": {"kept": True}}, f)
    pt_runner_bench.main(["--json", path, "--device", "cpu"])
    with open(path) as f:
        out = json.load(f)
    assert out["kernels"] == {"kept": True}
    st = out["runner"]
    for key in ("dspg600", "dpsvrg10"):
        row = st["resident"][key]
        assert row["transfers"]["resident"] == [1, 1]
        assert row["transfers"]["resident_device_sampling"] == [1, 1]
        assert row["history_max_abs_diff"] < 1e-4
    wire = {k: v["wire_bytes_per_step"] for k, v in st["backends"].items()
            if v["ms_per_step"] is not None}
    # banded sends fewer bytes than dense, int8 a quarter of dense
    assert wire["banded"] < wire["dense"]
    assert wire["compressed"] == wire["dense"] / 4
    g = st["graphs"]
    assert 1 <= g["scan_pieces_built"] <= 3 < g["distinct_round_lengths"]
    assert st["left_out"] == pt_runner_bench.LEFT_OUT == {}
    assert st["backends"]["ppermute"]["wire_bytes_per_step"] == \
        wire["banded"]


def test_mesh_rows_wire_figures(mesh):
    """The rows across ranks: ppermute's bytes a step on the 4-node ring are
    the banded accounting's, below dense's; the compressed per-link maps
    sum exactly to bytes_per_step at 4 and 3 bits, and a sharded
    compressed(ppermute) run's bytes equal compressed(dense)'s; the cells
    and nodes rows equal their unsharded twins (the bench asserts them at
    rtol 1e-4 / atol 1e-6) with a (1, 1) ledger a rank, over gloo."""
    from repro_torch.core import algorithm, graphs, runner
    from repro_torch.core.exec_spec import ExecSpec
    from benchmarks import pt_common as common
    pp = mesh["ppermute"]
    data, _, h, x0, _ = common.setup_problem("adult_like", 0.02, m=4,
                                             device="cpu")
    problem = algorithm.Problem(common.logreg_loss, h, x0, data)
    banded = runner.run(pt_runner_bench._dpsvrg(problem, 8, 2), problem,
                        graphs.b_connected_ring_schedule(4, b=1, seed=0),
                        ExecSpec(resident=True, gossip="banded",
                                 device="cpu"), seed=0, record_every=0)
    steps = int(banded.history.steps[-1])
    assert pp["ring4_wire_bytes_per_step"] == \
        int(banded.extras["wire_bytes"][-1]) / steps
    assert pp["ring4_wire_bytes_per_step"] < \
        pp["dense_ring4_wire_bytes_per_step"]
    assert pp["wire"] == "gloo" and pp["transfers"] == [1, 1]
    sh = mesh["shard_stats"]
    cp = sh["compressed_ppermute"]
    for bits in (4, 3):
        entry = cp[f"bits{bits}"]
        assert entry["bytes_per_step"] > 0
    assert cp["wire_bytes_equal"]
    assert cp["sharded_vs_dense_max_abs_diff"] < 1e-4
    assert sh["cells_sweep8"]["history_max_abs_diff"] < 1e-5
    assert sh["nodes_dspg"]["history_max_abs_diff"] < 1e-5
    assert sh["cells_sweep8"]["transfers"] == [1, 1]
    assert sh["nodes_dspg"]["transfers"] == [1, 1]
    assert sh["wire"] == "gloo" and sh["nodes_dspg"]["m"] == 32
