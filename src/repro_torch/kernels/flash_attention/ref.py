"""Plain PyTorch version of the flash attention kernel (GQA, causal or
bidirectional, sliding window, softcap): the CPU path of
``ops.flash_attention`` and the kernel's oracle on the card.

``attention_ref`` takes the JAX package's oracle layout, q (B, H, Sq, hd)
and k, v (B, KV, Sk, hd).  Query i sees key j when j <= i (causal, both
counted from 0) and j > i - window.  A row with no key left gives 0, as the
TPU kernel and the CUDA kernel give (the JAX oracle would average v there);
the model's causal rows always keep their own key, so the two agree on
every row the model produces.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "mask"]


def mask(sq: int, sk: int, *, causal: bool, sliding_window, device=None):
    """(Sq, Sk) bool: True where query i may attend to key j."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if sliding_window is not None:
        ok &= kp > qp - sliding_window
    return ok


def attention_ref(q, k, v, *, causal: bool = True,
                  sliding_window: int | None = None,
                  softcap: float | None = None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) with H % KV == 0.
    Returns (B, H, Sq, hd); softmax in float32."""
    b, h, sq, hd = q.shape
    kv = k.shape[1]
    rep = h // kv
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    ok = mask(sq, k.shape[2], causal=causal, sliding_window=sliding_window,
              device=q.device)
    logits = torch.where(ok[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(ok.any(dim=-1)[None, None, :, None], probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
