"""The benchmark's data, found by name: ``BENCHMARK.json`` and the files of
each configuration, traffic mix and per-layer metric."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

from .env import BENCH, ROOT


class Manifest:
    """``BENCHMARK.json`` at ``root``, with lookups by name.  The entries of
    cells kept out of the benchmark until their runs hold a bound
    (``pending/<cell>.json``, each in ``BENCHMARK.json``'s form) are found
    too, so that such a cell can still be rehearsed and tested; the
    benchmark's runs name only the cells of ``BENCHMARK.json``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        for path in sorted((BENCH / "pending").glob("*.json")):
            for key, entries in load_json(path).items():
                self.data[key] = self.data[key] + entries

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        """The configuration's file, as it is run."""
        return load_json(self.root / self.config_entry(name)["file"])

    def end_to_end(self, workload: str) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.data["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.data["per_layer"]:
            cells = m.get("workloads")
            if (workload in cells) if cells is not None else m["moves"] in e2e:
                out.append(m)
        return out


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "traffic" / f"{name}.json")


def metric_reader(name: str, bench: Path = BENCH):
    """The module of ``metrics/<name>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"pbcore.drivers.{name}")
