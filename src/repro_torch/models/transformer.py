"""Transformer assembly: decoder stacks of attention, Mamba, mLSTM and
sLSTM blocks with dense or MoE FFNs, encoder-decoder (whisper) and an
early-fused image prefix (llava), from a ``ModelConfig`` + ``layer_plan``.

The port of ``repro.models.transformer``.  Public surface (plain functions
over nested-dict params with the JAX package's keys and nesting):

  init_params(cfg, seed_or_generator, device)          -> params
  forward(cfg, params, tokens, **modality)             -> (logits, aux_loss)
  loss_fn(cfg) -> fn(params, batch)                    -> scalar
  prefill(cfg, params, tokens, **modality, max_len)    -> (last_logits, cache)
  decode_step(cfg, params, cache, token)               -> (logits, cache)

``modality`` is ``image_embeds`` (B, P, d) for a ``vision_stub`` config:
projected by ``vision_proj`` and put before the tokens, so the learned
positions and the cache count the prefix and ``forward`` cuts the logits
to the text positions; or ``audio_frames`` (B, F, d), which an encoder
config requires: the encoder (bidirectional, no RoPE, its own learned
positions) runs once and every decoder layer cross-attends to its output
after the mixer's residual and before the FFN.

The JAX package scans over layer groups (``api.scan_group_size``) with
remat to compile one body; the port runs a Python loop over the layers
and computes the same numbers.  MoE layers (``moe.moe_forward``) add their
load-balance aux: ``forward`` sums it over the layers and ``loss_fn`` adds
``moe_aux_weight * aux / num_layers``, as the reference does; ``prefill``
and ``decode_step`` drop it (the reference's prefill sums it and never
returns the sum).

A cache holds a (B,) position vector and one entry a layer: the KV ring
buffers of an attention layer (``{"kv": ...}``, and in an encoder-decoder
``"cross"``, the K and V of the encoder output, which decode reads and
never writes) or the recurrent state of an SSM layer (``{"mamba": {h,
conv}}``, ``{"mlstm": {c, n, m, conv}}``, ``{"slstm": {c, n, h, m}}``).
``decode_step`` updates the KV buffers in place
(``attention.attention_decode``) and returns each SSM state as new tensors
in its layer's entry.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from . import attention, common, ffn as ffn_lib, moe as moe_lib, placed, \
    ssm
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
            # on placed activations, the kernel on each rank's rows
            return placed.rmsnorm_kernel(x, p["w"])
        return common.rms_norm(x, p["w"])
    return common.layer_norm(x, p["w"], p["b"])


def _dtype(cfg: ModelConfig):
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, plan: LayerPlan, gen, dtype,
                cross: bool = False):
    p: dict[str, Any] = {"norm1": _init_norm(cfg, dtype, gen.device)}
    if plan.mixer == "attn":
        p["attn"] = attention.init_attention(gen, plan.attn, dtype)
    elif plan.mixer == "mamba":
        p["mamba"] = ssm.init_mamba(gen, plan.mamba, dtype)
    elif plan.mixer == "mlstm":
        p["mlstm"] = ssm.init_mlstm(gen, plan.mlstm, dtype)
    else:
        p["slstm"] = ssm.init_slstm(gen, plan.slstm, dtype)
    if cfg.post_norm:
        p["post_norm1"] = _init_norm(cfg, dtype, gen.device)
    if cross:
        p["cross_norm"] = _init_norm(cfg, dtype, gen.device)
        p["cross"] = attention.init_attention(gen, _cross_spec(plan), dtype)
    if plan.ffn != "none":
        p["norm2"] = _init_norm(cfg, dtype, gen.device)
        if plan.ffn == "moe":
            p["moe"] = moe_lib.init_moe(gen, plan.moe, dtype)
        else:
            p["ffn"] = ffn_lib.init_ffn(gen, cfg.d_model, cfg.d_ff,
                                        plan.ffn, dtype)
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
    is_encdec = cfg.encoder_layers > 0
    params: dict[str, Any] = {
        "embed": common.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": _init_norm(cfg, dtype, device),
        "layers": [_init_block(cfg, pl, gen, dtype, cross=is_encdec)
                   for pl in plans],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype)
    if not cfg.use_rope:
        params["pos_embed"] = common.dense_init(
            gen, (cfg.max_position, cfg.d_model), dtype, scale=0.02)
    if is_encdec:
        enc_plan = _encoder_plan(cfg)
        params["encoder"] = {
            "layers": [_init_block(cfg, enc_plan, gen, dtype)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": _init_norm(cfg, dtype, device),
            "pos_embed": common.dense_init(
                gen, (max(cfg.encoder_seq, 1), cfg.d_model), dtype,
                scale=0.02),
        }
    if cfg.frontend == "vision_stub":
        # the projector is part of the backbone (the vision tower a stub)
        params["vision_proj"] = common.dense_init(
            gen, (cfg.d_model, cfg.d_model), dtype)
    return params


def param_count(params) -> int:
    return sum(int(leaf.numel()) for leaf in pytree.tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ffn_block(cfg: ModelConfig, plan: LayerPlan, p, x):
    """The block's FFN half on the residual stream x: (x, aux), aux None
    but for an MoE layer."""
    aux = None
    if plan.ffn == "none":
        return x, aux
    h = _apply_norm(cfg, p["norm2"], x)
    if plan.ffn == "moe":
        y, aux = moe_lib.moe_forward(p["moe"], plan.moe, h)
    else:
        y = ffn_lib.ffn_forward(p["ffn"], h, plan.ffn)
    if cfg.post_norm:
        y = _apply_norm(cfg, p["post_norm2"], y)
    return x + (cfg.residual_scale or 1.0) * y, aux


def _mixer_residual(cfg: ModelConfig, p, x, mix):
    if cfg.post_norm:
        mix = _apply_norm(cfg, p["post_norm1"], mix)
    return x + (cfg.residual_scale or 1.0) * mix


def _cross_spec(plan: LayerPlan) -> attention.AttnSpec:
    return dataclasses.replace(plan.attn, cross=True, causal=False)


def _cross_block(cfg: ModelConfig, plan: LayerPlan, p, x, cross_cache):
    """The cross-attention sub-block on the residual stream x (no residual
    scale, as the reference adds it)."""
    h = _apply_norm(cfg, p["cross_norm"], x)
    return x + attention.cross_attention_apply(p["cross"], _cross_spec(plan),
                                               h, cross_cache)


def _block_forward(cfg: ModelConfig, plan: LayerPlan, p, x, enc_out=None):
    """Full-sequence block forward.  Returns (x, aux)."""
    h = _apply_norm(cfg, p["norm1"], x)
    if plan.mixer == "attn":
        mix = attention.attention_forward(p["attn"], plan.attn, h)
    elif plan.mixer == "mamba":
        mix = placed.channel_call(ssm.mamba_forward, "mamba", p["mamba"],
                                  plan.mamba, h)
    elif plan.mixer == "mlstm":
        mix = placed.channel_call(ssm.mlstm_forward, "mlstm", p["mlstm"],
                                  plan.mlstm, h, unit=plan.mlstm.head_dim)
    else:
        mix = placed.replicated_call(ssm.slstm_forward, p["slstm"],
                                     plan.slstm, h)
    x = _mixer_residual(cfg, p, x, mix)
    if enc_out is not None:
        cc = attention.cross_attention_cache(p["cross"], _cross_spec(plan),
                                             enc_out)
        x = _cross_block(cfg, plan, p, x, cc)
    return _ffn_block(cfg, plan, p, x)


def _encoder_plan(cfg: ModelConfig) -> LayerPlan:
    """The encoder's block: bidirectional attention without RoPE (so never
    the flash kernel), a gelu FFN."""
    return LayerPlan(
        mixer="attn",
        attn=attention.AttnSpec(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
            causal=False, use_rope=False),
        ffn="gelu")


def _encode(cfg: ModelConfig, params, frames):
    """Whisper's encoder over precomputed (stub) frame embeddings."""
    enc = params["encoder"]
    x = frames + enc["pos_embed"][None, :frames.shape[1]]
    plan = _encoder_plan(cfg)
    for p in enc["layers"]:
        x, _ = _block_forward(cfg, plan, p, x)
    return _apply_norm(cfg, enc["final_norm"], x)


def _encoder_output(cfg: ModelConfig, params, audio_frames):
    """The encoder's output for an encoder-decoder config, else None."""
    if cfg.encoder_layers == 0:
        return None
    if audio_frames is None:
        raise ValueError(f"{cfg.name} requires audio_frames")
    return _encode(cfg, params, audio_frames)


def _embed_scale(cfg: ModelConfig, x):
    if not cfg.embed_scale:
        return x
    # sqrt(d) formed in float32, then cast, as the JAX package forms it;
    # multiplied in as a host scalar (no host-to-device copy)
    scale = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=torch.float32)
    return x * float(scale.to(x.dtype))


def _embed_inputs(cfg: ModelConfig, params, tokens, image_embeds=None,
                  position_offset: int = 0):
    """(x, prefix): the embedded tokens, after the projected image rows
    where there are any (prefix = their count)."""
    # F.embedding (placed.embedding's plain route), not indexing: the same
    # rows, and under the trainer's vmap over nodes its backward sums
    # repeated tokens in a fixed order, where indexing's batched backward
    # does not (a resume must be bitwise); a placed table is looked up
    # vocab-parallel over its split rows
    x = _embed_scale(cfg, placed.embedding(tokens, params["embed"]))
    prefix = 0
    if image_embeds is not None:
        img = image_embeds.to(x.dtype) @ params["vision_proj"]
        x = torch.cat([img, x], dim=1)
        prefix = image_embeds.shape[1]
    if not cfg.use_rope:
        pos = torch.arange(x.shape[1], device=x.device) + position_offset
        x = x + params["pos_embed"][pos][None]
    return x, prefix


def _lm_logits(cfg: ModelConfig, params, x):
    x = _apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = placed.whole_last_dim(logits).to(getattr(torch, cfg.logit_dtype))
    return common.softcap(logits, cfg.final_softcap)


def forward(cfg: ModelConfig, params, tokens, image_embeds=None,
            audio_frames=None):
    """Training forward.  tokens: (B, L) int -> (logits (B, L, V), aux):
    the logits of the text positions only, an image prefix cut off."""
    plans = layer_plan(cfg)
    enc_out = _encoder_output(cfg, params, audio_frames)
    x, prefix = _embed_inputs(cfg, params, tokens, image_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, plan in zip(params["layers"], plans):
        x, aux = _block_forward(cfg, plan, p, x, enc_out)
        if aux is not None:
            aux_total = aux_total + aux
    logits = _lm_logits(cfg, params, x)
    if prefix:
        logits = logits[:, prefix:]
    return logits, aux_total


def loss_fn(cfg: ModelConfig):
    """Cross-entropy next-token loss closure.  batch keys: tokens, labels
    (+ image_embeds / audio_frames for the stub modalities)."""

    def fn(params, batch):
        logits, aux = forward(cfg, params, batch["tokens"],
                              image_embeds=batch.get("image_embeds"),
                              audio_frames=batch.get("audio_frames"))
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        labels = batch["labels"].to(torch.int64)
        correct = torch.gather(logits, -1, labels[..., None])[..., 0]
        loss = torch.mean(logz - correct)
        if cfg.moe_period > 0:
            loss = loss + cfg.moe_aux_weight * aux / max(cfg.num_layers, 1)
        return loss

    return fn


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    dtype = dtype or _dtype(cfg)
    device = common.resolve_device(device)
    layers = []
    for plan in layer_plan(cfg):
        if plan.mixer == "attn":
            entry = {"kv": attention.init_kv_cache(batch, max_len, plan.attn,
                                                   dtype, device)}
        elif plan.mixer == "mamba":
            entry = {"mamba": ssm.mamba_init_state(plan.mamba, batch, dtype,
                                                   device)}
        elif plan.mixer == "mlstm":
            entry = {"mlstm": ssm.mlstm_init_state(plan.mlstm, batch, dtype,
                                                   device)}
        else:
            entry = {"slstm": ssm.slstm_init_state(plan.slstm, batch, dtype,
                                                   device)}
        if cfg.encoder_layers > 0 and plan.mixer == "attn":
            shp = (batch, max(cfg.encoder_seq, 1), cfg.num_kv_heads, cfg.hd)
            entry["cross"] = {
                "k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
        layers.append(entry)
    # per-slot positions (continuous batching: rows advance independently)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "layers": layers}


def prefill(cfg: ModelConfig, params, tokens, image_embeds=None,
            audio_frames=None, max_len: int | None = None):
    """Run the prompt, returning last-position logits + a ready cache.
    ``max_len`` counts every cache position, an image prefix included; the
    cache's positions start at prefix + L."""
    plans = layer_plan(cfg)
    b = tokens.shape[0]
    enc_out = _encoder_output(cfg, params, audio_frames)
    x, _ = _embed_inputs(cfg, params, tokens, image_embeds)
    total = x.shape[1]
    max_len = max(max_len or (total + 64), total)
    cache_layers = []
    for p, plan in zip(params["layers"], plans):
        h = _apply_norm(cfg, p["norm1"], x)
        if plan.mixer == "attn":
            mix, kv = attention.attention_prefill(p["attn"], plan.attn, h,
                                                  max_len=max_len)
            entry = {"kv": kv}
        elif plan.mixer == "mamba":
            mix, st = placed.channel_call(_mamba_prefill, "mamba",
                                          p["mamba"], plan.mamba, h)
            entry = {"mamba": st}
        elif plan.mixer == "mlstm":
            mix, st = placed.channel_call(_mlstm_prefill, "mlstm",
                                          p["mlstm"], plan.mlstm, h,
                                          unit=plan.mlstm.head_dim)
            entry = {"mlstm": st}
        else:
            mix, st = placed.replicated_call(_slstm_prefill, p["slstm"],
                                             plan.slstm, h)
            entry = {"slstm": st}
        x = _mixer_residual(cfg, p, x, mix)
        if enc_out is not None:
            entry["cross"] = attention.cross_attention_cache(
                p["cross"], _cross_spec(plan), enc_out)
            x = _cross_block(cfg, plan, p, x, entry["cross"])
        x, _ = _ffn_block(cfg, plan, p, x)
        cache_layers.append(entry)
    logits = _lm_logits(cfg, params, x[:, -1:])
    pos = torch.full((b,), total, dtype=torch.int32, device=x.device)
    return logits[:, 0], {"pos": pos, "layers": cache_layers}


def _mamba_prefill(p, spec, x, ch=ssm.WHOLE):
    """The training forward, returning the final recurrent and conv
    states with the output."""
    u, z, dt, b_mat, c_mat, conv_state = ssm._mamba_inputs(p, spec, x,
                                                           ch=ch)
    h_final, ys = ssm._mamba_scan(spec, p, u, dt, b_mat, c_mat)
    return ssm._mamba_out(p, x, u, z, ys), {"h": h_final, "conv": conv_state}


def _mlstm_prefill(p, spec, x, ch=ssm.WHOLE):
    inner, gate, q, k, v, i_t, f_t, conv_state = ssm._mlstm_qkvif(p, spec, x,
                                                                  ch=ch)
    st, hs = ssm._mlstm_scan(spec, q, k, v, i_t, f_t)
    out = ssm._mlstm_out(p, spec, x, inner, gate, hs, ch)
    return out, {"c": st[0], "n": st[1], "m": st[2], "conv": conv_state}


def _slstm_prefill(p, spec, x):
    st, hs = ssm._slstm_scan(p, spec, x)
    return ssm._slstm_out(p, x, hs), {"c": st[0], "n": st[1], "h": st[2],
                                       "m": st[3]}


def decode_step(cfg: ModelConfig, params, cache, token):
    """One-token decode.  token: (B,) int -> (logits (B, V), cache).

    cache["pos"] is a (B,) vector: rows may sit at different positions
    (continuous batching).  The KV buffers are updated in place; the
    returned cache holds the same buffers, the new SSM states and the
    advanced positions."""
    plans = layer_plan(cfg)
    pos = cache["pos"]
    if placed.is_placed(pos):
        pos = pos.full_tensor()
    pos = torch.broadcast_to(pos.to(torch.int32), (token.shape[0],))
    embed = params["embed"]
    x = _embed_scale(cfg, placed.embedding(token, embed)[:, None, :]
                     if placed.is_placed(embed) else embed[token][:, None, :])
    if not cfg.use_rope:
        x = x + params["pos_embed"][torch.clamp(
            pos, max=params["pos_embed"].shape[0] - 1)][:, None, :]
    new_layers = []
    for p, plan, entry in zip(params["layers"], plans, cache["layers"]):
        h = _apply_norm(cfg, p["norm1"], x)
        if plan.mixer == "attn":
            mix, kv = attention.attention_decode(p["attn"], plan.attn, h,
                                                 entry["kv"], pos)
            new_entry = dict(entry, kv=kv)
        elif plan.mixer == "mamba":
            mix, st = placed.channel_call(ssm.mamba_step, "mamba",
                                          p["mamba"], plan.mamba, h,
                                          entry["mamba"])
            new_entry = dict(entry, mamba=st)
        elif plan.mixer == "mlstm":
            mix, st = placed.channel_call(ssm.mlstm_step, "mlstm",
                                          p["mlstm"], plan.mlstm, h,
                                          entry["mlstm"],
                                          unit=plan.mlstm.head_dim)
            new_entry = dict(entry, mlstm=st)
        else:
            mix, st = placed.replicated_call(ssm.slstm_step, p["slstm"],
                                             plan.slstm, h, entry["slstm"])
            new_entry = dict(entry, slstm=st)
        x = _mixer_residual(cfg, p, x, mix)
        if "cross" in entry:
            x = _cross_block(cfg, plan, p, x, entry["cross"])
        # a decode batch's rows share the MoE capacity; the aux is dropped
        x, _ = _ffn_block(cfg, plan, p, x)
        new_layers.append(new_entry)
    logits = _lm_logits(cfg, params, x)[:, 0]
    return logits, {"pos": pos + 1, "layers": new_layers}
