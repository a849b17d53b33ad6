"""A dense decoder-only transformer in plain PyTorch: the forward pass and
loss of h2o-danube-1.8b (arXiv:2401.16818; Mistral-style), written from
its description, in float32 with TF32 off unless a control asks for it.

Per layer, on the residual stream x (B, T, d):

    h = rms(x) * (1 + g1)                    RMSNorm, eps as configured
    q, k, v = h Wq, h Wk, h Wv               32 query heads, 8 kv heads of 80
    q, k <- RoPE (half-split, theta 1e4)     at absolute positions 0..T-1
    a = softmax(q k^T / sqrt(80) + mask) v   causal, window 4096: query i
                                             sees key j iff i-4096 < j <= i
    x = x + a Wo
    h = rms(x) * (1 + g2)
    x = x + (silu(h Wg) * (h Wu)) Wd         SwiGLU
    logits = (rms(x) * (1 + gf)) H           H the head (d, V), or E^T
                                             where the embedding is tied

Query head j reads kv head j // 4.  The norms' gains are stored as offsets
from 1 (the layout the program keeps its weights in).  Weights are a dict
tree: embed (V, d), final_norm {w}, layers [{norm1 {w}, attn {wq, wk, wv,
wo}, norm2 {w}, ffn {w_gate, w_up, w_down}}], and lm_head (d, V) where
the embedding is not tied."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import Precision, no_tf32


def rms(x, w, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + w)


def rope(x, pos, theta: float):
    """x (B, T, H, hd) at positions pos (T,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(torch.float32)[:, None] * freqs           # (T, half)
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(p, cfg: dict, h, prec: Precision):
    B, T, _ = h.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = prec.matmul(h, p["wq"]).reshape(B, T, H, hd)
    k = prec.matmul(h, p["wk"]).reshape(B, T, KV, hd)
    v = prec.matmul(h, p["wv"]).reshape(B, T, KV, hd)
    pos = torch.arange(T, device=h.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = prec.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    i = pos[:, None]
    j = pos[None, :]
    ok = j <= i
    if cfg.get("sliding_window"):
        ok = ok & (j > i - cfg["sliding_window"])
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = prec.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, H * hd)
    return prec.matmul(out, p["wo"])


def forward(params, cfg: dict, tokens, prec: Precision | None = None):
    """tokens (B, T) int -> logits (B, T, V)."""
    no_tf32()
    prec = prec or Precision()
    eps = cfg["norm_eps"]
    x = F.embedding(tokens, params["embed"])
    for p in params["layers"]:
        x = x + attention(p["attn"], cfg, rms(x, p["norm1"]["w"], eps), prec)
        h = rms(x, p["norm2"]["w"], eps)
        f = p["ffn"]
        x = x + prec.matmul(F.silu(prec.matmul(h, f["w_gate"]))
                            * prec.matmul(h, f["w_up"]), f["w_down"])
    x = rms(x, params["final_norm"]["w"], eps)
    head = params["embed"].T if cfg["tie_embeddings"] else params["lm_head"]
    return prec.matmul(x, head)


def loss(params, cfg: dict, tokens, labels, prec: Precision | None = None):
    """Mean next-token cross-entropy over (B, T)."""
    logits = forward(params, cfg, tokens, prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).to(torch.int64))
