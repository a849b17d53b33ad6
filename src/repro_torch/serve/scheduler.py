"""Continuous-batching serving scheduler: the host reference.

The port of ``repro.serve.scheduler``.  Finished sequences retire and new
requests are admitted into their slots while the others keep decoding.
This works because the decode path carries a PER-SLOT position vector
(``cache["pos"]: (B,)``): each row of the shared KV cache advances
independently.

Flow:
  submit(Request)  -> queued
  step():
    1. admit queued requests into free slots (single-row prefill of the
       prompt and its image or audio, the row spliced into the shared cache
       with ``cache_insert``),
    2. one batched decode step for ALL slots (idle slots decode garbage
       that is ignored and overwritten on admission),
    3. retire slots that hit max_new_tokens or EOS.
  run_until_done() -> {uid: np.ndarray(generated tokens)}

One decode dispatch and one pull of the picked tokens per token: the
resident engine (``engine.ResidentEngine``) is the fast path.  Greedy
decoding by default; plug a ``sampler(logits) -> tokens`` for others.

A request's ``image_embeds`` (P, d) or ``audio_frames`` (F, d) go to
``prefill`` as batch-1 tensors on the params' device.  Its row cache must
have the shared cache's shape, so a request whose image prefix pushes the
cache past ``max_len``, or whose audio has other than the config's
``encoder_seq`` frames, is refused with a ``ValueError`` that names the
cause (the JAX package's splice fails on such a row with a shape error).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..models import attention, transformer
from ..models.api import ModelConfig, layer_plan

__all__ = ["Request", "ContinuousBatcher", "cache_insert",
           "modality_inputs"]


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray                 # (L,) prompt
    max_new_tokens: int = 16
    image_embeds: np.ndarray | None = None
    audio_frames: np.ndarray | None = None


def cache_insert(slot_cache, row_cache, slot):
    """Splice a batch-1 cache into row ``slot`` of the shared cache, in
    place; returns the shared cache."""
    dst_leaves, spec = pytree.tree_flatten(slot_cache)
    src_leaves, src_spec = pytree.tree_flatten(row_cache)
    if src_spec != spec:
        raise ValueError("the row cache and the shared cache differ in "
                         "structure")
    for dst, src in zip(dst_leaves, src_leaves):
        dst[slot] = src[0].to(dst.dtype)
    return pytree.tree_unflatten(dst_leaves, spec)


def params_device(params) -> torch.device:
    return params["embed"].device


def modality_inputs(cfg: ModelConfig, req: Request, max_len: int,
                    device) -> dict:
    """``prefill``'s image_embeds / audio_frames for ``req``, batch-1
    tensors on ``device``; raises ``ValueError`` where the row cache would
    not fit the shared one (``max_len`` slots, ``encoder_seq`` frames)."""
    kw = {}
    if req.image_embeds is not None:
        total = len(req.image_embeds) + len(req.tokens)
        if total > max_len and any(
                p.mixer == "attn" and attention.kv_alloc(p.attn, total) !=
                attention.kv_alloc(p.attn, max_len) for p in layer_plan(cfg)):
            raise ValueError(
                f"request {req.uid}: image prefix of {len(req.image_embeds)} "
                f"and prompt of {len(req.tokens)} tokens take {total} cache "
                f"positions, past max_len={max_len}")
        kw["image_embeds"] = torch.as_tensor(
            np.asarray(req.image_embeds), device=device)[None]
    if req.audio_frames is not None:
        frames = len(req.audio_frames)
        if cfg.encoder_layers > 0 and frames != max(cfg.encoder_seq, 1):
            raise ValueError(
                f"request {req.uid}: audio of {frames} frames, but the "
                f"cross-attention cache holds encoder_seq="
                f"{cfg.encoder_seq}")
        kw["audio_frames"] = torch.as_tensor(
            np.asarray(req.audio_frames), device=device)[None]
    return kw


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, max_slots: int,
                 max_len: int, eos_id: int | None = None,
                 sampler: Callable | None = None):
        self.cfg = cfg
        self.params = params
        self.device = params_device(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.sampler = sampler
        self.cache = transformer.init_cache(cfg, max_slots, max_len,
                                            device=self.device)
        self.queue: deque[Request] = deque()
        self.slot_req: list[Request | None] = [None] * max_slots
        self.slot_generated: list[list[int]] = [[] for _ in range(max_slots)]
        self.next_token = np.zeros(max_slots, np.int32)
        self.outputs: dict[int, np.ndarray] = {}

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

    def _admit(self):
        for slot in range(self.max_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            kw = modality_inputs(self.cfg, req, self.max_len, self.device)
            toks = torch.as_tensor(np.asarray(req.tokens, np.int32),
                                   device=self.device)[None]
            logits, row_cache = transformer.prefill(
                self.cfg, self.params, toks, max_len=self.max_len, **kw)
            self.cache = cache_insert(self.cache, row_cache, slot)
            self.slot_req[slot] = req
            self.slot_generated[slot] = []
            self.next_token[slot] = int(self._pick(logits)[0])

    def _pick(self, logits):
        if self.sampler is not None:
            picked = self.sampler(logits)
        else:
            picked = torch.argmax(logits, dim=-1)
        return np.asarray(torch.as_tensor(picked).cpu()).astype(np.int32)

    @torch.no_grad()
    def step(self):
        self._admit()
        if not any(r is not None for r in self.slot_req):
            return
        # record the tokens being fed (they are this step's emissions)
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                self.slot_generated[slot].append(int(self.next_token[slot]))
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(self.next_token, device=self.device))
        picked = self._pick(logits)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            done = len(self.slot_generated[slot]) >= req.max_new_tokens
            if self.eos_id is not None and \
                    self.slot_generated[slot][-1] == self.eos_id:
                done = True
            if done:
                self.outputs[req.uid] = np.asarray(self.slot_generated[slot],
                                                   np.int32)
                self.slot_req[slot] = None
            else:
                self.next_token[slot] = int(picked[slot])
