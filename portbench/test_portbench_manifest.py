"""BENCHMARK.json and the files it names: names, units and sizes within
the contract's limits, every cell's data and readers found by name, and
every per-layer metric reported where the end-to-end metric it moves is."""

from pbcore import env

env.prepare()


import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_units_better_and_sources():
    for m in _metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_configs_files_and_reductions():
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith("portbench/")
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and "hidden" not in key
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_workloads_find_their_data_and_metrics():
    from pbcore import manifest
    man = manifest.Manifest(ROOT)
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = manifest.traffic(w["traffic"])
        manifest.driver(traffic["driver"])
        e2e = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = man.per_layer(w["name"])
        assert layer
        for m in layer:
            assert m["moves"] in e2e
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_metric_has_a_reader_and_every_cell_a_config_used():
    from pbcore import manifest
    for m in BENCH["per_layer"]:
        mod = manifest.metric_reader(m["name"])
        assert callable(mod.read) and mod.READS
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_files_under_paths_have_plain_names():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_pending_cells_are_whole_and_apart():
    """A cell kept out of the benchmark (``pending/``) has its config,
    traffic, metrics and readers, and shares no name with the benchmark's."""
    from pbcore import manifest
    for f in sorted((ROOT / "portbench" / "pending").glob("*.json")):
        part = json.loads(f.read_text())
        assert set(part) <= {"configs", "workloads", "end_to_end",
                             "per_layer"}
        for kind, entries in part.items():
            ours = {e["name"] for e in BENCH[kind]}
            for e in entries:
                assert NAME.match(e["name"]) and e["name"] not in ours
        for w in part["workloads"]:
            assert f.stem == w["name"]
            man = manifest.Manifest(ROOT)
            assert (ROOT / man.config_entry(w["config"])["file"]).is_file()
            manifest.driver(manifest.traffic(w["traffic"])["driver"])
            e2e = {m["name"] for m in man.end_to_end(w["name"])}
            assert "setup_s" in e2e and len(e2e) >= 2
            for m in man.per_layer(w["name"]):
                assert m["moves"] in e2e
                assert callable(manifest.metric_reader(m["name"]).read)
