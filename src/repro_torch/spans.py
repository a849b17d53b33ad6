"""Named spans at the port's layer boundaries, for ``torch.profiler``.

A span is a ``record_function`` range: the profiler records it on the same
clock as the device's activity, so a trace can put each of the card's idle
gaps down to the innermost span open at that moment, and
``launch/inspect_trace.py`` can join each kernel to the span that launched
it.  With the profiler off, ``span`` returns one shared null context: a
span then costs one boolean check, where a ``record_function`` range would
still make two dispatcher calls.

The spans, by layer (a child indented under its parent):

* resident driver (``core/runner.py``): ``resident.plan``,
  ``resident.stage``, ``resident.execute``, ``resident.pull``;
* sweep driver (``core/sweep.py``): ``sweep.plan``, ``sweep.stage``,
  ``sweep.execute``, ``sweep.pull``;
* serving engine (``serve/engine.py``, ``ResidentEngine``):
  ``engine.step``, holding ``engine.admit`` (one an admission, holding
  ``engine.upload``, ``engine.prefill`` and ``engine.splice``),
  ``engine.decode_chunk`` (holding ``engine.replay``, one a replay of the
  chunk's CUDA graph, and ``engine.capture``, the graph's warm-up and
  capture on the engine's first chunk) and ``engine.pull``;
* LM trainer (``train/trainer.py``, ``train_loop``): ``train.build``,
  ``train.plan`` (resident path), ``train.stage``, ``train.refresh``,
  ``train.step`` (holding ``train.grad`` and ``train.mix`` of the
  unsharded step, ``train/steps.py``), ``train.record``, ``train.ckpt``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span(name): ...``: a ``record_function`` range named
    ``name`` while the profiler records, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
