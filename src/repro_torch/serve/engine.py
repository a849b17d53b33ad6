"""Device-resident continuous batching.

The port of ``repro.serve.engine``.  The host
:class:`~repro_torch.serve.scheduler.ContinuousBatcher` pulls the picked
tokens to the host after every decode step.  This engine keeps the hot path
on the device:

* **Slot state lives on the device** (:class:`SlotState`: active mask,
  next-token vector, remaining-token budgets) next to the shared KV cache
  with its per-slot position vector.
* **Decode runs in chunks** of ``chunk`` decode steps on device tensors.
  Each step emits the pending token of every *active* slot, decrements its
  budget, retires slots that hit EOS or their budget by clearing the mask
  (retired slots keep decoding garbage that the emission mask hides,
  exactly like the host batcher's idle slots), and picks the next token on
  the device.
* **Admission** prefills the prompt (with its image or audio, as
  ``scheduler.modality_inputs`` gives them) as a batch-1 row against the
  engine's fixed ``max_len`` (uniform row-cache shapes) and splices it into
  the shared cache by slot index, the cross-attention K/V included, seeding
  the slot state on the device.
* **Generated tokens accumulate on the device** in a preallocated
  ``(chunk, slots)`` emission buffer and are pulled ONCE per chunk together
  with the emission mask and the post-chunk active mask.
  ``engine.transfers`` is the ledger ({h2d, d2h, chunks}): h2d = one prompt
  upload per admission, d2h = one pull per chunk, as the reference counts.

* **The chunk replays one CUDA graph** where the params are on the current
  CUDA device and not placed, and the sampler is the default greedy one.
  The first chunk captures it (``core.cuda_graphs.GraphCapture``, after one
  warm-up on scratch copies of the state); every chunk replays it.  The
  graph's static buffers are the engine's own state: it reads the slot
  state, the positions, the KV caches and the SSM states, writes the
  emission buffer, and copies the new slot state, positions and SSM states
  back into the same tensors (the KV caches update in place).  Admissions
  write those tensors in place between replays, so a replay sees them with
  no copy.  The captured body is the eager chunk's own code (``_chunk``).
  Elsewhere the chunk runs eagerly: on the CPU, on a card that is not the
  current device, across ranks (their host-staged collectives cannot be
  captured), with a custom sampler (which may sync the host), and where the
  capture raises.  ``engine.graphs`` is {captures, replays, capture_s}.

Per-request outputs equal the host batcher's and standalone prefill +
decode's, because each cache row's computation is independent of its batch
neighbours.  A custom ``sampler`` maps ``logits (B, V)`` to ``(B,)`` int
tokens on the device.

Under ``torch.profiler`` a step is the span ``engine.step``, holding one
``engine.admit`` an admission (``engine.upload``, ``engine.prefill``,
``engine.splice``), then ``engine.decode_chunk`` (holding ``engine.replay``
where the chunk replays its graph, and ``engine.capture`` on the chunk that
captures it) and ``engine.pull`` (``repro_torch.spans``).
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core import cuda_graphs
from ..models import placed, transformer
from ..models.api import ModelConfig
from ..spans import span
from .scheduler import (Request, cache_insert, modality_inputs,
                        params_device)

__all__ = ["ResidentEngine", "SlotState"]


class SlotState(NamedTuple):
    """Per-slot decode state, resident on the device (leading axis = slots)."""
    active: torch.Tensor      # (S,) bool: slot is mid-generation
    next_tok: torch.Tensor    # (S,) int32: pending emission / next input
    remaining: torch.Tensor   # (S,) int32: tokens still to emit


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _use_graphs(device: torch.device, params, pick) -> bool:
    """Whether an engine replays its decode chunk as a CUDA graph: params on
    the current CUDA device (a capture records the current device's stream;
    work on another card would run outside it), none of them placed (a run
    across ranks, whose host-staged collectives cannot be captured), and the
    default greedy sampler (a custom one may sync the host)."""
    return device.type == "cuda" \
        and device.index == torch.cuda.current_device() \
        and not placed.any_placed(params) and pick is _greedy


class ResidentEngine:
    """Continuous batcher with a device-resident hot path.

    Same client API as :class:`~repro_torch.serve.scheduler.ContinuousBatcher`
    (``submit`` / ``busy`` / ``step`` / ``run_until_done`` / ``outputs``)
    with ``step()`` advancing one *chunk* of decode steps instead of one
    token.
    """

    def __init__(self, cfg: ModelConfig, params, max_slots: int,
                 max_len: int, eos_id: int | None = None,
                 sampler: Callable | None = None, chunk: int = 16):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.cfg = cfg
        self.params = params
        self.device = params_device(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.chunk = chunk
        self._pick = sampler if sampler is not None else _greedy

        self.queue: deque[Request] = deque()
        self.slot_req: list[Request | None] = [None] * max_slots
        self.slot_generated: list[list[int]] = [[] for _ in range(max_slots)]
        self.outputs: dict[int, np.ndarray] = {}
        self.transfers = {"h2d": 0, "d2h": 0, "chunks": 0}
        self.graphs = {"captures": 0, "replays": 0, "capture_s": 0.0}
        # the chunk's CUDA graph: None until the first chunk captures it,
        # False where chunks run eagerly
        self._graph = None if _use_graphs(self.device, params, self._pick) \
            else False

        dev = self.device
        self.cache = transformer.init_cache(cfg, max_slots, max_len,
                                            device=dev)
        self.state = SlotState(
            active=torch.zeros((max_slots,), dtype=torch.bool, device=dev),
            next_tok=torch.zeros((max_slots,), dtype=torch.int32, device=dev),
            remaining=torch.zeros((max_slots,), dtype=torch.int32,
                                  device=dev))
        # the chunk's emission buffer: rows 0..chunk-1 tokens, rows
        # chunk..2*chunk-1 the emission mask, the last row the active mask
        self._ys = torch.zeros((2 * chunk + 1, max_slots), dtype=torch.int32,
                               device=dev)

    # -- client API ---------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def run_until_done(self, max_steps: int = 10000) -> dict:
        steps = 0
        while self.busy and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.outputs)

    # -- engine -------------------------------------------------------------

    def _admit(self, slot: int, req: Request):
        with span("engine.upload"):
            kw = modality_inputs(self.cfg, req, self.max_len, self.device)
            toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                                   device=self.device)[None]
        # the prompt upload, modality or not, as the JAX engine counts it
        self.transfers["h2d"] += 1
        with span("engine.prefill"):
            logits, row_cache = transformer.prefill(
                self.cfg, self.params, toks, max_len=self.max_len, **kw)
        with span("engine.splice"):
            self.cache = cache_insert(self.cache, row_cache, slot)
            st = self.state
            st.active[slot] = True
            st.next_tok[slot] = self._pick(logits)[0].to(torch.int32)
            st.remaining[slot] = int(req.max_new_tokens)

    def _admit_all(self):
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            if len(req.tokens) >= self.max_len:
                raise ValueError(
                    f"request {req.uid}: prompt length {len(req.tokens)} "
                    f"does not fit the engine's max_len={self.max_len} cache")
            with span("engine.admit"):
                self._admit(slot, req)
            self.slot_req[slot] = req
            self.slot_generated[slot] = []

    def _chunk(self, st: SlotState, cache):
        """``chunk`` decode steps on device tensors from ``st`` and
        ``cache``; fills ``self._ys`` and returns the new (state, cache)."""
        n = self.chunk
        for i in range(n):
            emit = st.next_tok
            emitted = st.active
            rem = st.remaining - emitted.to(torch.int32)
            done = emitted & (rem <= 0)
            if self.eos_id is not None:
                done = done | (emitted & (emit == self.eos_id))
            # decode ALL slots (retired/idle rows produce garbage the
            # emission mask hides): the same batched step as the host loop
            logits, cache = transformer.decode_step(self.cfg, self.params,
                                                    cache, emit)
            picked = self._pick(logits).to(torch.int32)
            keep = st.active & ~done
            self._ys[i] = emit
            self._ys[n + i] = emitted.to(torch.int32)
            st = SlotState(active=keep,
                           next_tok=torch.where(keep, picked, st.next_tok),
                           remaining=rem)
        self._ys[2 * n] = st.active.to(torch.int32)
        return st, cache

    def _run_chunk(self):
        """One decode chunk; fills ``self._ys``.  Replays the chunk's graph
        where the engine has one (the first chunk captures it), else runs
        ``_chunk`` eagerly."""
        if self._graph is None:
            self._graph = self._capture_chunk()
        if self._graph:
            with span("engine.replay"):
                self._graph()
            self.graphs["replays"] += 1
            return
        self.state, self.cache = self._chunk(self.state, self.cache)

    def _capture_chunk(self):
        """Capture ``_chunk`` over the engine's own state, which it copies
        its new state back into; returns the graph's replay, or False where
        the capture raises (the engine's chunks then run eagerly)."""
        t0 = time.perf_counter()
        live = (self.state, self.cache)
        buffers, spec = pytree.tree_flatten(live)
        scratch = pytree.tree_unflatten([b.clone() for b in buffers], spec)

        def record():
            cuda_graphs.store(buffers, spec, self._chunk(*live))

        try:
            with span("engine.capture"), torch.no_grad():
                replay = cuda_graphs.GraphCapture().new_graph(
                    record, warm_up=lambda: self._chunk(*scratch))
        except RuntimeError as err:
            warnings.warn(f"the decode chunk cannot be captured into a CUDA "
                          f"graph, so it runs eagerly: {err}")
            return False
        self.graphs["captures"] += 1
        self.graphs["capture_s"] += time.perf_counter() - t0
        return replay

    @torch.no_grad()
    def step(self) -> dict[int, int]:
        """Admit queued requests, run ONE decode chunk, pull the emission
        buffer once.  Returns {uid: n_new_tokens} for this chunk."""
        with span("engine.step"):
            self._admit_all()
            if not any(r is not None for r in self.slot_req):
                return {}
            with span("engine.decode_chunk"):
                self._run_chunk()
            with span("engine.pull"):
                ys = self._ys.cpu().numpy()           # ONE pull per chunk
            self.transfers["d2h"] += 1
            self.transfers["chunks"] += 1
            n = self.chunk
            toks, mask, active = ys[:n], ys[n:2 * n].astype(bool), ys[2 * n]
            events: dict[int, int] = {}
            for slot, req in enumerate(self.slot_req):
                if req is None:
                    continue
                new = toks[mask[:, slot], slot].tolist()
                if new:
                    self.slot_generated[slot].extend(new)
                    events[req.uid] = len(new)
                if not active[slot]:
                    self.outputs[req.uid] = np.asarray(
                        self.slot_generated[slot], np.int32)
                    self.slot_req[slot] = None
            return events
