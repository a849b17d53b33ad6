"""The port's metrics trackers against the JAX package's (``repro.train.
tracker``): the same metrics give the same history columns, JSONL lines
and spec resolution."""

import numpy as np
import pytest
import torch

from repro.train import tracker as jtracker
from repro_torch.train import tracker as ttracker

# numpy scalars as the reference's trainer logs them; the port's trainer
# logs Python floats, and a 0-d tensor converts through .item() as well
METRICS = [({"loss": np.float32(1.5), "v_norm": 2.0, "alpha": 0.05,
             "wire_bytes": 123456, "time": 0.25}, 0),
           ({"loss": 0.75, "v_norm": np.float64(1.25), "alpha": 0.05,
             "wire_bytes": 246912, "time": 0.5}, 10)]
SUMMARY = {"algorithm": "dpsvrg", "steps": 20, "final_loss": 0.75,
           "transfers": {"h2d": 1, "d2h": 3}, "resident": True,
           "sampling": "host", "wire_bytes": 246912, "wall_time": 1.5}


def _drive(tracker):
    for metrics, step in METRICS:
        tracker.log_metrics(metrics, step=step)
    tracker.log_summary(SUMMARY)
    tracker.finish()
    tracker.finish()                        # idempotent


def test_jsonl_lines_equal_the_reference(tmp_path):
    paths = {}
    for name, pkg in (("jax", jtracker), ("torch", ttracker)):
        paths[name] = tmp_path / name / "metrics.jsonl"
        t = pkg.JsonlTracker(str(paths[name]))
        assert not paths[name].exists()     # constructing touches nothing
        _drive(t)
    assert paths["torch"].read_text() == paths["jax"].read_text()
    assert len(paths["torch"].read_text().splitlines()) == 3


def test_jsonl_tracker_takes_tensors_as_numbers(tmp_path):
    t = ttracker.JsonlTracker(str(tmp_path / "m.jsonl"))
    t.log_metrics({"loss": torch.tensor(1.5)}, step=3)
    t.finish()
    assert (tmp_path / "m.jsonl").read_text() == '{"step": 3, "loss": 1.5}\n'


def test_history_and_composite_equal_the_reference():
    hists = {}
    for name, pkg in (("jax", jtracker), ("torch", ttracker)):
        h1, h2 = pkg.HistoryTracker(), pkg.HistoryTracker()
        _drive(pkg.CompositeTracker([h1, h2]))
        assert h1.history() == h2.history() and h1.summary == h2.summary
        hists[name] = (h1.history(), h1.summary)
    assert hists["torch"] == hists["jax"]


def test_resolve_tracker_equals_the_reference(tmp_path):
    for pkg in (jtracker, ttracker):
        assert pkg.resolve_tracker(None) == []
        h = pkg.HistoryTracker()
        assert pkg.resolve_tracker(h) == [h]
        both = pkg.resolve_tracker([h, f"jsonl:{tmp_path}/y.jsonl"])
        assert both[0] is h and isinstance(both[1], pkg.JsonlTracker)
        with pytest.raises(ValueError, match="unknown tracker spec"):
            pkg.resolve_tracker("wandb:run")
        with pytest.raises(TypeError):
            pkg.resolve_tracker(3)
