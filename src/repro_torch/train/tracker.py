"""Pluggable metrics trackers for the LM trainer (levanter-style).

The trainer pushes one metrics dict per log window (``log_metrics``), one
run-level summary at the end (``log_summary``), and closes the sinks with
``finish``.  WHERE those land is the plugin axis:

* :class:`HistoryTracker` — in-memory dict-of-lists (the trainer's return
  value rides on one, so ``train_loop`` keeps its historical ``hist`` shape).
* :class:`JsonlTracker` — one JSON object per line, append-friendly and
  cheap enough to leave on for long runs; the natural artifact for
  ``--tracker jsonl:<path>`` launches.
* :class:`CompositeTracker` — fan-out to several sinks.

``resolve_tracker`` turns the config-level spec (``None``, a ``Tracker``,
``"jsonl:<path>"``, or a list of those) into tracker instances, so launch
entry points stay declarative.

The port's own copy of ``repro.train.tracker`` (plain Python): the same
metrics give the same JSONL lines.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

__all__ = ["Tracker", "HistoryTracker", "JsonlTracker", "CompositeTracker",
           "resolve_tracker"]


class Tracker:
    """Protocol base: override any subset; all methods default to no-ops."""

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        """One record point: ``metrics`` is a flat name -> scalar dict."""

    def log_summary(self, summary: dict) -> None:
        """Run-level summary (final loss, wall time, transfer ledger, ...)."""

    def finish(self) -> None:
        """Flush/close the sink.  Idempotent."""


class HistoryTracker(Tracker):
    """Accumulates the metric stream as dict-of-lists (plus a ``step``
    column), preserving the trainer's historical ``hist`` return shape."""

    def __init__(self):
        self._cols: dict[str, list] = {"step": []}
        self.summary: dict = {}

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        self._cols["step"].append(int(step))
        for name, value in metrics.items():
            self._cols.setdefault(name, []).append(value)

    def log_summary(self, summary: dict) -> None:
        self.summary.update(summary)

    def history(self) -> dict:
        return {k: list(v) for k, v in self._cols.items()}


class JsonlTracker(Tracker):
    """One JSON object per line: ``{"step": ..., <metrics>}`` per record
    point, ``{"summary": {...}}`` at run end.  The file handle is opened
    lazily (append mode) so constructing the tracker never touches disk."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _handle(self):
        if self._fh is None:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(self.path, "a")
        return self._fh

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        row = {"step": int(step)}
        row.update({k: _jsonable(v) for k, v in metrics.items()})
        fh = self._handle()
        fh.write(json.dumps(row) + "\n")
        fh.flush()

    def log_summary(self, summary: dict) -> None:
        fh = self._handle()
        fh.write(json.dumps({"summary": _jsonable(summary)}) + "\n")
        fh.flush()

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CompositeTracker(Tracker):
    """Fan-out: every call forwards to each child in order."""

    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log_metrics(self, metrics: dict, *, step: int) -> None:
        for t in self.trackers:
            t.log_metrics(metrics, step=step)

    def log_summary(self, summary: dict) -> None:
        for t in self.trackers:
            t.log_summary(summary)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


def _jsonable(value: Any):
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if hasattr(value, "item"):            # numpy scalars, 0-d tensors
        return value.item()
    return value


def resolve_tracker(spec) -> list[Tracker]:
    """``None`` | ``Tracker`` | ``"jsonl:<path>"`` | list of those ->
    tracker instances."""
    if spec is None:
        return []
    if isinstance(spec, Tracker):
        return [spec]
    if isinstance(spec, (list, tuple)):
        out: list[Tracker] = []
        for s in spec:
            out.extend(resolve_tracker(s))
        return out
    if isinstance(spec, str):
        kind, _, arg = spec.partition(":")
        if kind == "jsonl" and arg:
            return [JsonlTracker(arg)]
        raise ValueError(
            f"unknown tracker spec {spec!r}: expected 'jsonl:<path>', a "
            f"Tracker instance, or a list of those")
    raise TypeError(f"cannot resolve tracker from {type(spec).__name__}")
