"""Transformer assembly for decoder-only stacks of attention blocks with
dense FFNs, from a ``ModelConfig`` + ``layer_plan``.

The port of ``repro.models.transformer``.  Public surface (plain functions
over nested-dict params with the JAX package's keys and nesting):

  init_params(cfg, seed_or_generator, device) -> params
  forward(cfg, params, tokens)                -> (logits, aux_loss)
  loss_fn(cfg) -> fn(params, batch)           -> scalar
  prefill(cfg, params, tokens, max_len)       -> (last_logits, cache)
  decode_step(cfg, params, cache, token)      -> (logits, cache)

The JAX package scans over layer groups to compile one body; the port runs
a Python loop over the layers and computes the same numbers.  Other mixers,
the encoder and modality inputs raise ``NotImplementedError`` by ROADMAP
item (``api.check_supported``).  ``decode_step`` updates the KV cache in
place (``attention.attention_decode``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from . import attention, common, ffn as ffn_lib
from .api import LayerPlan, ModelConfig, layer_plan

__all__ = ["init_params", "forward", "loss_fn", "prefill", "decode_step",
           "init_cache", "param_count"]


# ---------------------------------------------------------------------------
# Norm helpers
# ---------------------------------------------------------------------------

def _init_norm(cfg: ModelConfig, dtype, device):
    if cfg.norm == "rmsnorm":
        return {"w": common.zeros_init((cfg.d_model,), dtype, device)}
    return {"w": common.ones_init((cfg.d_model,), dtype, device),
            "b": common.zeros_init((cfg.d_model,), dtype, device)}


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "rmsnorm":
        if cfg.use_fused_norm:
            from ..kernels.rmsnorm import ops as rmsnorm_ops
            return rmsnorm_ops.rmsnorm(x, p["w"])
        return common.rms_norm(x, p["w"])
    return common.layer_norm(x, p["w"], p["b"])


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, plan: LayerPlan, gen, dtype):
    p: dict[str, Any] = {"norm1": _init_norm(cfg, dtype, gen.device)}
    p["attn"] = attention.init_attention(gen, plan.attn, dtype)
    if cfg.post_norm:
        p["post_norm1"] = _init_norm(cfg, dtype, gen.device)
    if plan.ffn != "none":
        p["norm2"] = _init_norm(cfg, dtype, gen.device)
        p["ffn"] = ffn_lib.init_ffn(gen, cfg.d_model, cfg.d_ff, plan.ffn,
                                    dtype)
        if cfg.post_norm:
            p["post_norm2"] = _init_norm(cfg, dtype, gen.device)
    return p


def init_params(cfg: ModelConfig, seed_or_generator=0, device="cuda"):
    """Random parameters on ``device`` (the card unless the caller asks for
    the CPU), drawn in the JAX package's order from one generator."""
    device = common.resolve_device(device)
    gen = common.make_generator(seed_or_generator, device)
    dtype = _dtype(cfg)
    plans = layer_plan(cfg)
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": _init_norm(cfg, dtype, device),
        "layers": [_init_block(cfg, pl, gen, dtype) for pl in plans],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)
    if not cfg.use_rope:
        params["pos_embed"] = common.dense_init(
            gen, (cfg.max_position, cfg.d_model), dtype, scale=0.02)
    return params


def param_count(params) -> int:
    return sum(int(leaf.numel()) for leaf in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _block_forward(cfg: ModelConfig, plan: LayerPlan, p, x):
    res_scale = cfg.residual_scale or 1.0
    h = _apply_norm(cfg, p["norm1"], x)
    mix = attention.attention_forward(p["attn"], plan.attn, h)
    if cfg.post_norm:
        mix = _apply_norm(cfg, p["post_norm1"], mix)
    x = x + res_scale * mix
    if plan.ffn != "none":
        h = _apply_norm(cfg, p["norm2"], x)
        y = ffn_lib.ffn_forward(p["ffn"], h, plan.ffn)
        if cfg.post_norm:
            y = _apply_norm(cfg, p["post_norm2"], y)
        x = x + res_scale * y
    return x


def _embed_scale(cfg: ModelConfig, x):
    if not cfg.embed_scale:
        return x
    # sqrt(d) formed in float32, then cast, as the JAX package forms it;
    # multiplied in as a host scalar (no host-to-device copy)
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32)
    return x * float(scale.to(x.dtype))


def _embed_inputs(cfg: ModelConfig, params, tokens):
    x = _embed_scale(cfg, params["embed"][tokens])
    if not cfg.use_rope:
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + params["pos_embed"][pos][None]
    return x


def _lm_logits(cfg: ModelConfig, params, x):
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.to(getattr(torch, cfg.logit_dtype))
    return common.softcap(logits, cfg.final_softcap)


def _no_modalities(cfg: ModelConfig, image_embeds, audio_frames):
    if image_embeds is not None or audio_frames is not None:
        raise NotImplementedError(
            f"{cfg.name}: image and audio inputs are not ported yet (ROADMAP "
            "Queue 1 item 10: encoder-decoder and multimodal)")


def forward(cfg: ModelConfig, params, tokens, image_embeds=None,
            audio_frames=None):
    """Training forward.  tokens: (B, L) int -> (logits (B, L, V), aux)."""
    _no_modalities(cfg, image_embeds, audio_frames)
    plans = layer_plan(cfg)
    x = _embed_inputs(cfg, params, tokens)
    for p, plan in zip(params["layers"], plans):
        x = _block_forward(cfg, plan, p, x)
    logits = _lm_logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig):
    """Cross-entropy next-token loss closure.  batch keys: tokens, labels."""

    def fn(params, batch):
        logits, _ = forward(cfg, params, batch["tokens"],
                            image_embeds=batch.get("image_embeds"),
                            audio_frames=batch.get("audio_frames"))
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        labels = batch["labels"].to(torch.int64)
        correct = torch.gather(logits, -1, labels[..., None])[..., 0]
        return torch.mean(logz - correct)

    return fn


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    dtype = dtype or _dtype(cfg)
    device = common.resolve_device(device)
    layers = [{"kv": attention.init_kv_cache(batch, max_len, plan.attn,
                                             dtype, device)}
              for plan in layer_plan(cfg)]
    # per-slot positions (continuous batching: rows advance independently)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": layers}


def prefill(cfg: ModelConfig, params, tokens, image_embeds=None,
            audio_frames=None, max_len: int | None = None):
    """Run the prompt, returning last-position logits + a ready cache."""
    _no_modalities(cfg, image_embeds, audio_frames)
    plans = layer_plan(cfg)
    b = tokens.shape[0]
    x = _embed_inputs(cfg, params, tokens)
    total = x.shape[1]
    max_len = max(max_len or (total + 64), total)
    res_scale = cfg.residual_scale or 1.0
    cache_layers = []
    for p, plan in zip(params["layers"], plans):
        h = _apply_norm(cfg, p["norm1"], x)
        mix, kv = attention.attention_prefill(p["attn"], plan.attn, h,
                                              max_len=max_len)
        if cfg.post_norm:
            mix = _apply_norm(cfg, p["post_norm1"], mix)
        x = x + res_scale * mix
        if plan.ffn != "none":
            hh = _apply_norm(cfg, p["norm2"], x)
            y = ffn_lib.ffn_forward(p["ffn"], hh, plan.ffn)
            if cfg.post_norm:
                y = _apply_norm(cfg, p["post_norm2"], y)
            x = x + res_scale * y
        cache_layers.append({"kv": kv})
    logits = _lm_logits(cfg, params, x[:, -1:])
    pos = torch.full((b,), total, dtype=torch.int32, device=x.device)
    return logits[:, 0], {"pos": pos, "layers": cache_layers}


def decode_step(cfg: ModelConfig, params, cache, token):
    """One-token decode.  token: (B,) int -> (logits (B, V), cache).

    cache["pos"] is a (B,) vector: rows may sit at different positions
    (continuous batching).  The KV buffers are updated in place; the
    returned cache holds the same buffers and the advanced positions."""
    plans = layer_plan(cfg)
    pos = torch.broadcast_to(cache["pos"].to(torch.int32), (token.shape[0],))
    x = _embed_scale(cfg, params["embed"][token][:, None, :])
    if not cfg.use_rope:
        x = x + params["pos_embed"][torch.clamp(
            pos, max=params["pos_embed"].shape[0] - 1)][:, None, :]
    res_scale = cfg.residual_scale or 1.0
    new_layers = []
    for p, plan, entry in zip(params["layers"], plans, cache["layers"]):
        h = _apply_norm(cfg, p["norm1"], x)
        mix, kv = attention.attention_decode(p["attn"], plan.attn, h,
                                             entry["kv"], pos)
        if cfg.post_norm:
            mix = _apply_norm(cfg, p["post_norm1"], mix)
        x = x + res_scale * mix
        if plan.ffn != "none":
            hh = _apply_norm(cfg, p["norm2"], x)
            y = ffn_lib.ffn_forward(p["ffn"], hh, plan.ffn)
            if cfg.post_norm:
                y = _apply_norm(cfg, p["post_norm2"], y)
            x = x + res_scale * y
        new_layers.append(dict(entry, kv=kv))
    logits = _lm_logits(cfg, params, x)[:, 0]
    return logits, {"pos": pos + 1, "layers": new_layers}
