"""Plain PyTorch version of the flash attention kernel (GQA, causal or
bidirectional, sliding window, softcap): the CPU path of
``ops.flash_attention`` and the kernel's oracle on the card.

``attention_ref`` takes the JAX package's oracle layout, q (B, H, Sq, hd)
and k, v (B, KV, Sk, hd).  Query i sees key j when j <= i (causal, both
counted from 0) and j > i - window.  A row with no key left gives 0, as the
TPU kernel and the CUDA kernel give (the JAX oracle would average v there);
the model's causal rows always keep their own key, so the two agree on
every row the model produces.

``bf16_bound`` is the element-wise error that the bf16 kernel may show
against ``attention_ref`` on the float32 values of its inputs, derived from
where the kernel rounds.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "bf16_bound", "mask"]


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


def _probs(q, k, *, causal, sliding_window, softcap):
    """Softmax probabilities (B, H, Sq, Sk), float32, 0 on a row with no
    key; logits from q and k in their own dtype."""
    b, h, sq, hd = q.shape
    k = torch.repeat_interleave(k, h // k.shape[1], dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    logits = logits / math.sqrt(hd)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    ok = mask(sq, k.shape[2], causal=causal, sliding_window=sliding_window,
              device=q.device)
    logits = torch.where(ok[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.where(ok.any(dim=-1)[None, None, :, None], probs,
                       torch.zeros_like(probs))


def attention_ref(q, k, v, *, causal: bool = True,
                  sliding_window: int | None = None,
                  softcap: float | None = None):
    """q: (B, H, Sq, hd); k, v: (B, KV, Sk, hd) with H % KV == 0.
    Returns (B, H, Sq, hd); softmax in float32."""
    probs = _probs(q, k, causal=causal, sliding_window=sliding_window,
                   softcap=softcap)
    v = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def bf16_bound(q, k, v, *, causal: bool = True,
               sliding_window: int | None = None,
               softcap: float | None = None):
    """(plain, bound) for bf16 inputs q: (B, H, Sq, hd), k, v: (B, KV, Sk,
    hd): ``plain`` is ``attention_ref`` on their float32 values, and the
    bf16 kernel's output must satisfy |out - plain| <= bound element by
    element, both float32 (B, H, Sq, hd), where

        bound = 2^-8 (probs @ |v|) + 4e-3 |plain| + 2e-5.

    The kernel rounds each probability p to bf16 before P V (at most 2^-9
    of p, so 2^-9 of probs @ |v| in the output); the factor 2 covers l
    being summed from rounded or unrounded p.  4e-3 > 2^-8 covers the
    output's own rounding to bf16, and 2e-5 the float32 tolerance."""
    q, k, v = (t.float() for t in (q, k, v))
    probs = _probs(q, k, causal=causal, sliding_window=sliding_window,
                   softcap=softcap)
    v = torch.repeat_interleave(v, q.shape[1] // v.shape[1], dim=1)
    plain = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    bound = torch.einsum("bhqk,bhkd->bhqd", probs, v.abs())
    return plain, bound * 2.0 ** -8 + 4e-3 * plain.abs() + 2e-5
