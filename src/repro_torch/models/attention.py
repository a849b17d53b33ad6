"""Grouped-query attention with the masking variants of the dense decoders,
plus the KV-cache prefill and decode paths.

The port of ``repro.models.attention``.  Variants (selected per layer by
the config): full causal, sliding-window causal, chunked-local causal,
bidirectional, and logit softcap.  Cross-attention waits for the
encoder-decoder slice (ROADMAP Queue 1 item 10).

The plain path is tensor code (``_sdpa``).  ``use_flash`` routes the
no-cache forward through ``kernels.flash_attention`` where ``_flash_ok``
allows it: on the card that is the hand-written CUDA kernel, which launches
or raises; on the CPU its plain version.  Decode attention stays tensor
code, as the JAX package computes it outside any kernel.

The decode path writes the new key and value into the cache in place: the
cache passed to ``attention_decode`` is the cache it returns.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import common

__all__ = ["AttnSpec", "init_attention", "attention_forward",
           "init_kv_cache", "attention_decode", "attention_prefill"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    sliding_window: int | None = None   # None = full
    chunk: int | None = None            # chunked-local (llama4)
    softcap: float | None = None        # attn logit softcap (gemma2: 50.0)
    causal: bool = True                 # False for encoder self-attn
    cross: bool = False                 # cross-attention (not ported)
    use_rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    use_flash: bool = False
    # multi-device activation sharding: not ported, a set value raises
    shard_constraint: tuple | None = None


def init_attention(gen: torch.Generator, spec: AttnSpec, dtype=torch.float32):
    d, h, kv, hd = spec.d_model, spec.num_heads, spec.num_kv_heads, spec.head_dim
    p = {
        "wq": common.dense_init(gen, (d, h * hd), dtype),
        "wk": common.dense_init(gen, (d, kv * hd), dtype),
        "wv": common.dense_init(gen, (d, kv * hd), dtype),
        "wo": common.dense_init(gen, (h * hd, d), dtype),
    }
    if spec.qk_norm:
        p["q_norm"] = common.zeros_init((hd,), dtype, gen.device)
        p["k_norm"] = common.zeros_init((hd,), dtype, gen.device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _merge_heads(x):
    return x.reshape(*x.shape[:-2], -1)


def _repeat_kv(k, num_heads):
    """(B, S, KV, hd) -> (B, S, H, hd) by broadcasting each group."""
    b, s, kv, hd = k.shape
    rep = num_heads // kv
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(b, s, kv, rep, hd).reshape(
        b, s, kv * rep, hd)


def _mask_bias(spec: AttnSpec, q_pos, k_pos):
    """Additive mask bias (Sq, Sk) from the layer's masking variant."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if spec.causal and not spec.cross:
        ok &= kp <= qp
    if spec.sliding_window is not None and not spec.cross:
        ok &= kp > qp - spec.sliding_window
    if spec.chunk is not None and not spec.cross:
        ok &= torch.div(kp, spec.chunk, rounding_mode="floor") == \
            torch.div(qp, spec.chunk, rounding_mode="floor")
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _sdpa(spec: AttnSpec, q, k, v, bias):
    """q: (B,Sq,H,hd) k,v: (B,Sk,H,hd) bias: (Sq,Sk) -> (B,Sq,H,hd)."""
    scale = 1.0 / math.sqrt(spec.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    logits = common.softcap(logits, spec.softcap)
    logits = logits + bias[None, None]
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _qkv(params, spec: AttnSpec, x):
    q = _split_heads(x @ params["wq"], spec.num_heads, spec.head_dim)
    k = _split_heads(x @ params["wk"], spec.num_kv_heads, spec.head_dim)
    v = _split_heads(x @ params["wv"], spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    return q, k, v


def _flash_ok(spec: AttnSpec, kv_src, positions) -> bool:
    """The flash kernel covers the self-attention causal variants (full,
    sliding-window, softcap, GQA).  Chunked-local masking, cross-attention,
    non-contiguous query positions and sharding-constrained runs take the
    plain path: the reference's own routing."""
    return (spec.use_flash and spec.causal and not spec.cross
            and spec.chunk is None and kv_src is None and positions is None
            and spec.shard_constraint is None)


def _check_spec(spec: AttnSpec, kv_src=None):
    if spec.cross or kv_src is not None:
        raise NotImplementedError(
            "cross-attention is not ported yet (ROADMAP Queue 1 item 10: "
            "encoder-decoder and multimodal)")
    if spec.shard_constraint is not None:
        raise NotImplementedError(
            "attention sharding constraints are multi-device work, not "
            "ported yet (ROADMAP Queue 1 item 14)")


def attention_forward(params, spec: AttnSpec, x, kv_src=None, positions=None):
    """Training/prefill forward without cache.  x: (B, S, d)."""
    return _forward(params, spec, x, kv_src, positions)[0]


def _forward(params, spec: AttnSpec, x, kv_src=None, positions=None):
    """attention_forward's output, with the RoPE'd k and v (B, S, KV, hd)
    it attended over, so that prefill caches them without projecting
    twice."""
    _check_spec(spec, kv_src)
    b, s, _ = x.shape
    q, k, v = _qkv(params, spec, x)
    sk = k.shape[1]
    q_pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    k_pos = torch.arange(sk, device=x.device)
    if spec.use_rope:
        cos, sin = common.rope_angles(q_pos, spec.head_dim, spec.rope_theta)
        q = common.apply_rope(q, cos, sin)
        kcos, ksin = common.rope_angles(k_pos, spec.head_dim, spec.rope_theta)
        k = common.apply_rope(k, kcos, ksin)
    if _flash_ok(spec, kv_src, positions):
        from ..kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(          # handles GQA: k/v unrepeated
            q, k, v, causal=True, sliding_window=spec.sliding_window,
            softcap=spec.softcap)
        return _merge_heads(out) @ params["wo"], k, v
    bias = _mask_bias(spec, q_pos, k_pos)
    out = _sdpa(spec, q, _repeat_kv(k, spec.num_heads),
                _repeat_kv(v, spec.num_heads), bias)
    return _merge_heads(out) @ params["wo"], k, v


# ---------------------------------------------------------------------------
# KV cache serving paths
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, spec: AttnSpec,
                  dtype=torch.float32, device=None):
    """Cache layout (B, S_max, KV, hd).  Sliding-window layers allocate only
    the window (ring buffer); chunked layers allocate the chunk."""
    if spec.sliding_window is not None:
        alloc = min(max_len, spec.sliding_window)
    elif spec.chunk is not None:
        alloc = min(max_len, spec.chunk)
    else:
        alloc = max_len
    shp = (batch, alloc, spec.num_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def attention_prefill(params, spec: AttnSpec, x, positions=None,
                      max_len: int | None = None):
    """Prefill: run forward AND return the populated ring-buffer cache.

    The cache is allocated for ``max_len`` total positions (>= prompt) and
    keeps the ring invariant *slot = position % alloc* so that
    ``attention_decode`` can continue from it.
    """
    b, s, _ = x.shape
    out, k, v = _forward(params, spec, x, positions=positions)
    cache = init_kv_cache(b, max(max_len or s, s), spec, x.dtype, x.device)
    alloc = cache["k"].shape[1]
    if s >= alloc:
        # keep the last `alloc` positions, rolled so slot == position % alloc
        shift = s % alloc
        cache["k"] = torch.roll(k[:, -alloc:], shift, dims=1).contiguous()
        cache["v"] = torch.roll(v[:, -alloc:], shift, dims=1).contiguous()
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    return out, cache


def attention_decode(params, spec: AttnSpec, x, cache, pos):
    """One-token decode.  x: (B, 1, d); pos: absolute position, a scalar or
    a (B,) vector (continuous batching: each slot at its own position).

    The cache is a ring buffer for windowed layers; for full layers it holds
    all past positions (entries beyond each row's ``pos`` are masked out).
    The new key and value are written into ``cache`` in place.
    """
    _check_spec(spec)
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = torch.broadcast_to(pos, (b,)).to(torch.int64)         # (B,)
    q, k_new, v_new = _qkv(params, spec, x)
    if spec.use_rope:
        cos, sin = common.rope_angles(pos[:, None], spec.head_dim,
                                      spec.rope_theta)           # (B,1,half)
        q = common.apply_rope(q, cos, sin)
        k_new = common.apply_rope(k_new, cos, sin)
    k_cache, v_cache = cache["k"], cache["v"]
    alloc = k_cache.shape[1]
    slot = pos % alloc                                           # (B,)
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v_new[:, 0].to(v_cache.dtype)

    # absolute position of each cache slot (ring-buffer aware), per row:
    # slot s holds the largest p <= pos with p % alloc == s
    slots = torch.arange(alloc, device=x.device)[None, :]       # (1, alloc)
    p = pos[:, None]                                             # (B, 1)
    abs_pos = p - torch.remainder(p - slots, alloc)              # (B, alloc)
    valid = abs_pos >= 0
    if spec.sliding_window is not None:
        valid &= abs_pos > p - spec.sliding_window
    if spec.chunk is not None:
        valid &= torch.div(abs_pos, spec.chunk, rounding_mode="floor") == \
            torch.div(p, spec.chunk, rounding_mode="floor")
    if spec.causal:
        valid &= abs_pos <= p
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    bias = torch.where(valid, zero, torch.full_like(zero, NEG_INF))

    # grouped-query form: each kv head serves its group of query heads, so
    # the cache is never repeated to H heads (the JAX package broadcasts it)
    h, kv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    qg = q[:, 0].reshape(b, kv, h // kv, hd)                     # (B,KV,r,hd)
    kt = k_cache.permute(0, 2, 3, 1)                             # (B,KV,hd,A)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.matmul(qg, kt).to(torch.float32) * scale      # (B,KV,r,A)
    logits = common.softcap(logits, spec.softcap)
    logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.matmul(probs, v_cache.permute(0, 2, 1, 3))      # (B,KV,r,hd)
    out = out.reshape(b, 1, h * hd)
    return out @ params["wo"], cache
