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
* **Admission** prefills the prompt as a batch-1 row against the engine's
  fixed ``max_len`` (uniform row-cache shapes) and splices it into the
  shared cache by slot index, seeding the slot state on the device.
* **Generated tokens accumulate on the device** in a preallocated
  ``(chunk, slots)`` emission buffer and are pulled ONCE per chunk together
  with the emission mask and the post-chunk active mask.
  ``engine.transfers`` is the ledger ({h2d, d2h, chunks}): h2d = one prompt
  upload per admission, d2h = one pull per chunk, as the reference counts.

Per-request outputs equal the host batcher's and standalone prefill +
decode's, because each cache row's computation is independent of its batch
neighbours.  A custom ``sampler`` maps ``logits (B, V)`` to ``(B,)`` int
tokens on the device.  The JAX engine compiles each chunk; the port runs it
eagerly (CUDA graphs of the chunk are later work).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..models import transformer
from ..models.api import ModelConfig
from .scheduler import Request, _no_modalities, cache_insert, params_device

__all__ = ["ResidentEngine", "SlotState"]


class SlotState(NamedTuple):
    """Per-slot decode state, resident on the device (leading axis = slots)."""
    active: torch.Tensor      # (S,) bool: slot is mid-generation
    next_tok: torch.Tensor    # (S,) int32: pending emission / next input
    remaining: torch.Tensor   # (S,) int32: tokens still to emit


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


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
        toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                               device=self.device)[None]
        self.transfers["h2d"] += 1          # the prompt upload
        logits, row_cache = transformer.prefill(self.cfg, self.params, toks,
                                                max_len=self.max_len)
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
            _no_modalities(req)
            self._admit(slot, req)
            self.slot_req[slot] = req
            self.slot_generated[slot] = []

    def _run_chunk(self):
        """``chunk`` decode steps on device tensors; fills ``self._ys``."""
        st, cache, n = self.state, self.cache, self.chunk
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
        self.state, self.cache = st, cache

    @torch.no_grad()
    def step(self) -> dict[int, int]:
        """Admit queued requests, run ONE decode chunk, pull the emission
        buffer once.  Returns {uid: n_new_tokens} for this chunk."""
        self._admit_all()
        if not any(r is not None for r in self.slot_req):
            return {}
        self._run_chunk()
        ys = self._ys.cpu().numpy()               # ONE pull per chunk
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
                self.outputs[req.uid] = np.asarray(self.slot_generated[slot],
                                                   np.int32)
                self.slot_req[slot] = None
        return events
