"""Each cell rehearsed on the CPU at a small size: the whole run of
``run.py`` but the look for a card, the program's outputs held against the
plain reference (``correct`` true), the result's line well formed, and
the traced run's per-layer metrics read."""

import json
import math

import pytest

from pbcore import env

env.prepare()

from pbcore import harness, manifest, tiny  # noqa: E402

CELLS = sorted(tiny.OVERRIDES)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_the_reference(cell):
    res = harness.run_cell(cell, 2**31 + 77, 0.3, False, device="cpu",
                           **tiny.OVERRIDES[cell])
    assert res["correct"], res["checks"]
    line = json.loads(harness.line(res))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    names = {m["name"] for m in manifest.Manifest().end_to_end(cell)}
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_its_layers(cell):
    res = harness.run_cell(cell, 31, 0.3, True, device="cpu",
                           **tiny.OVERRIDES[cell])
    assert res["correct"], res["checks"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in manifest.Manifest().per_layer(cell)}
    assert set(res["metrics"]) <= allowed
    for name, m in res["metrics"].items():
        assert math.isfinite(m["value"]), name
