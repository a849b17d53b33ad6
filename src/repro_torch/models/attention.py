"""Grouped-query attention with the masking variants the zoo needs, plus
the KV-cache prefill and decode paths and cross-attention.

The port of ``repro.models.attention``.  Variants (selected per layer by
the config): full causal, sliding-window causal, chunked-local causal,
bidirectional (whisper's encoder), cross-attention (whisper's decoder over
the encoder output: ``cross_attention_cache`` computes its K and V once,
``cross_attention_apply`` attends over them), and logit softcap.

The plain path is tensor code (``_sdpa``).  ``use_flash`` routes the
no-cache forward through ``kernels.flash_attention`` where ``_flash_ok``
allows it: on the card that is the hand-written CUDA kernel, which launches
or raises; on the CPU its plain version.  Decode attention stays tensor
code, as the JAX package computes it outside any kernel, and so do the
encoder's bidirectional layers and every cross-attention, by the
reference's own routing rule (``_flash_ok``).

The decode path writes the new key and value into the cache in place: the
cache passed to ``attention_decode`` is the cache it returns.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import common, placed

__all__ = ["AttnSpec", "init_attention", "attention_forward",
           "init_kv_cache", "attention_decode", "attention_prefill",
           "cross_attention_cache", "cross_attention_apply", "kv_alloc"]

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
    cross: bool = False                 # cross-attention (no RoPE on kv)
    use_rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    use_flash: bool = False
    # multi-device activation sharding (batch axis, head axis) of q, k and
    # v on placed (DTensor) operands; raises on plain ones, as the
    # reference's with_sharding_constraint does without a mesh
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


def _qkv(params, spec: AttnSpec, x, kv_src=None):
    kv_src = x if kv_src is None else kv_src
    q = _split_heads(x @ params["wq"], spec.num_heads, spec.head_dim)
    k = _split_heads(kv_src @ params["wk"], spec.num_kv_heads, spec.head_dim)
    v = _split_heads(kv_src @ params["wv"], spec.num_kv_heads, spec.head_dim)
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


def attention_forward(params, spec: AttnSpec, x, kv_src=None, positions=None):
    """Training/prefill forward without cache.  x: (B, S, d)."""
    return _forward(params, spec, x, kv_src, positions)[0]


def _forward(params, spec: AttnSpec, x, kv_src=None, positions=None):
    """attention_forward's output, with the RoPE'd k and v (B, S, KV, hd)
    it attended over, so that prefill caches them without projecting
    twice."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, spec, x, kv_src)
    sk = k.shape[1]
    q_pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    k_pos = torch.arange(sk, device=x.device)
    if spec.use_rope and not spec.cross:
        cos, sin = common.rope_angles(q_pos, spec.head_dim, spec.rope_theta)
        q = common.apply_rope(q, cos, sin)
        kcos, ksin = common.rope_angles(k_pos, spec.head_dim, spec.rope_theta)
        k = common.apply_rope(k, kcos, ksin)
    if _flash_ok(spec, kv_src, positions):
        from ..kernels.flash_attention import ops as fa_ops
        # handles GQA: k/v unrepeated
        out = placed.attention_core(
            lambda q_, k_, v_: fa_ops.flash_attention(
                q_, k_, v_, causal=True, sliding_window=spec.sliding_window,
                softcap=spec.softcap), q, k, v)
        return _merge_heads(out) @ params["wo"], k, v
    if spec.shard_constraint is not None:
        q, k, v = placed.constrain(spec.shard_constraint, q, k, v)
    bias = _mask_bias(spec, q_pos, k_pos)
    # each rank's heads, repeated to its own query heads
    out = placed.attention_core(
        lambda q_, k_, v_: _sdpa(spec, q_, _repeat_kv(k_, q_.shape[2]),
                                 _repeat_kv(v_, q_.shape[2]), bias), q, k, v)
    return _merge_heads(out) @ params["wo"], k, v


# ---------------------------------------------------------------------------
# KV cache serving paths
# ---------------------------------------------------------------------------

def kv_alloc(spec: AttnSpec, max_len: int) -> int:
    """Positions a layer's cache holds for ``max_len``: sliding-window
    layers only the window (ring buffer), chunked layers the chunk."""
    if spec.sliding_window is not None:
        return min(max_len, spec.sliding_window)
    if spec.chunk is not None:
        return min(max_len, spec.chunk)
    return max_len


def init_kv_cache(batch: int, max_len: int, spec: AttnSpec,
                  dtype=torch.float32, device=None):
    """Cache layout (B, alloc, KV, hd), alloc = ``kv_alloc``."""
    shp = (batch, kv_alloc(spec, max_len), spec.num_kv_heads, spec.head_dim)
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
    total = max(max_len or s, s)
    # on placed operands each rank fills its batch rows and heads of the
    # cache, which keeps the layout of k and v
    return out, placed.cache_core(
        lambda k_, v_: _fill_cache(spec, k_, v_, total), k, v,
        (b, kv_alloc(spec, total)) + tuple(k.shape[2:]))


def _fill_cache(spec: AttnSpec, k, v, max_len: int) -> dict:
    b, s = k.shape[:2]
    cache = init_kv_cache(b, max_len, dataclasses.replace(
        spec, num_kv_heads=k.shape[2]), k.dtype, k.device)
    alloc = cache["k"].shape[1]
    if s >= alloc:
        # keep the last `alloc` positions, rolled so slot == position % alloc
        shift = s % alloc
        cache["k"] = torch.roll(k[:, -alloc:], shift, dims=1).contiguous()
        cache["v"] = torch.roll(v[:, -alloc:], shift, dims=1).contiguous()
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    return cache


def attention_decode(params, spec: AttnSpec, x, cache, pos):
    """One-token decode.  x: (B, 1, d); pos: absolute position, a scalar or
    a (B,) vector (continuous batching: each slot at its own position).

    The cache is a ring buffer for windowed layers; for full layers it holds
    all past positions (entries beyond each row's ``pos`` are masked out).
    The new key and value are written into ``cache`` in place.
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos = torch.broadcast_to(pos, (b,)).to(torch.int64)         # (B,)
    q, k_new, v_new = _qkv(params, spec, x)
    if spec.use_rope and not spec.cross:
        cos, sin = common.rope_angles(pos[:, None], spec.head_dim,
                                      spec.rope_theta)           # (B,1,half)
        q = common.apply_rope(q, cos, sin)
        k_new = common.apply_rope(k_new, cos, sin)
    # on placed operands each rank attends over its batch rows and heads
    out, cache = placed.decode_core(
        lambda *a: _decode_core(spec, pos, *a), q, k_new, v_new, cache)
    return _merge_heads(out) @ params["wo"], cache


def _decode_core(spec: AttnSpec, pos, q, k_new, v_new, k_cache, v_cache,
                 rows):
    """Attention of q (B, 1, H, hd) over the cache after writing k_new and
    v_new into it, for the batch ``rows`` of ``pos``."""
    b = q.shape[0]
    pos = pos[rows]
    alloc = k_cache.shape[1]
    slot = pos % alloc                                           # (B,)
    brows = torch.arange(b, device=q.device)
    k_cache[brows, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[brows, slot] = v_new[:, 0].to(v_cache.dtype)

    # absolute position of each cache slot (ring-buffer aware), per row:
    # slot s holds the largest p <= pos with p % alloc == s
    slots = torch.arange(alloc, device=q.device)[None, :]       # (1, alloc)
    p = pos[:, None]                                             # (B, 1)
    abs_pos = p - torch.remainder(p - slots, alloc)              # (B, alloc)
    valid = abs_pos >= 0
    if spec.sliding_window is not None:
        valid &= abs_pos > p - spec.sliding_window
    if spec.chunk is not None:
        valid &= torch.div(abs_pos, spec.chunk, rounding_mode="floor") == \
            torch.div(p, spec.chunk, rounding_mode="floor")
    if spec.causal and not spec.cross:
        valid &= abs_pos <= p
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(valid, zero, torch.full_like(zero, NEG_INF))

    # grouped-query form: each kv head serves its group of query heads, so
    # the cache is never repeated to H heads (the JAX package broadcasts it)
    h, kv, hd = q.shape[2], k_cache.shape[2], spec.head_dim
    qg = q[:, 0].reshape(b, kv, h // kv, hd)                     # (B,KV,r,hd)
    kt = k_cache.permute(0, 2, 3, 1)                             # (B,KV,hd,A)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.matmul(qg, kt).to(torch.float32) * scale      # (B,KV,r,A)
    logits = common.softcap(logits, spec.softcap)
    logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.matmul(probs, v_cache.permute(0, 2, 1, 3))      # (B,KV,r,hd)
    return out.reshape(b, 1, h, hd)


def cross_attention_cache(params, spec: AttnSpec, enc_out):
    """K and V (B, S_enc, KV, hd) of the encoder output, computed once
    (whisper's decoder): no RoPE, as the reference computes them."""
    k = _split_heads(enc_out @ params["wk"], spec.num_kv_heads, spec.head_dim)
    v = _split_heads(enc_out @ params["wv"], spec.num_kv_heads, spec.head_dim)
    return {"k": k, "v": v}


def cross_attention_apply(params, spec: AttnSpec, x, cross_cache):
    """Queries from ``x`` (B, S, d) over a ``cross_attention_cache``, every
    key visible (a zero bias)."""
    q = _split_heads(x @ params["wq"], spec.num_heads, spec.head_dim)
    k, v = cross_cache["k"], cross_cache["v"]
    bias = torch.zeros((x.shape[1], k.shape[1]), dtype=torch.float32,
                       device=x.device)
    # each rank's heads, repeated to its own query heads
    out = placed.attention_core(
        lambda q_, k_, v_: _sdpa(spec, q_, _repeat_kv(k_, q_.shape[2]),
                                 _repeat_kv(v_, q_.shape[2]), bias), q, k, v)
    return _merge_heads(out) @ params["wo"]
