"""``benchmarks/pt_runner_bench.py`` on the CPU at a small size: every row
of the port's runner bench is produced (host loop, scan, resident with
host and device sampling for DSPG and DPSVRG; the dense, banded and
compressed transports; the per-round graph count; the LM trainer), its
assertions (ledgers, histories held to each other, the device-sampled
envelope) pass, the rows that need several devices are named as left out,
and ``pt_run --only runner`` drives it."""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import pt_run, pt_runner_bench  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def small(monkeypatch):
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
    left = [line for line in lines if "not run" in line]
    assert len(left) == 2 and all("item 14" in line for line in left)


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
    assert st["left_out"] == pt_runner_bench.LEFT_OUT
