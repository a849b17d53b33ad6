"""Model configuration schema and per-layer planning.

The port of ``repro.models.api``.  ``ModelConfig`` carries every field of
the JAX package's, so a configuration compares as data across the two
packages; ``layer_plan`` expands it into per-layer block specifications.

The port runs decoder-only stacks of attention blocks with dense FFNs.  A
plan that needs a mixer, an encoder or a frontend the port does not have
yet raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses

from . import attention

__all__ = ["ModelConfig", "LayerPlan", "layer_plan", "check_supported"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // num_heads
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    post_norm: bool = False              # gemma2 pre+post norm
    ffn_kind: str = "swiglu"             # swiglu | geglu | gelu | none
    residual_scale: float | None = None  # minicpm depth scaling

    # --- block pattern -----------------------------------------------------
    mixer_pattern: tuple = ("attn",)     # attn | mamba | mlstm | slstm

    # --- MoE ----------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_period: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch_groups: int = 1

    # --- attention variants ---------------------------------------------------
    sliding_window: int | None = None
    swa_period: int = 1                  # 2 => even layers local, odd global
    chunk: int | None = None             # chunked-local (llama4)
    chunk_period: int = 1
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    use_rope: bool = True
    nope_on_global: bool = False
    qk_norm: bool = False
    # route eligible attention layers through kernels/flash_attention (the
    # CUDA kernel on the card) in the no-cache forward (attention._flash_ok)
    use_flash: bool = False
    # route rmsnorm layers through kernels/rmsnorm (the CUDA kernel on the
    # card); layernorm configs ignore it
    use_fused_norm: bool = False
    max_position: int = 1 << 20
    # multi-device activation sharding: not ported, a set value raises
    attn_shard_constraint: tuple | None = None

    # --- SSM ----------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_expand: int = 2
    scan_chunk: int = 256

    # --- encoder-decoder / multimodal ---------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0
    frontend: str = "none"               # none | audio_stub | vision_stub
    image_tokens: int = 0

    # --- misc ----------------------------------------------------------------
    # scan_layers and remat_policy steer the JAX package's compilation; the
    # port runs a Python loop over the layers and keeps them as data only
    scan_layers: bool = True
    remat_policy: str = "full"
    tie_embeddings: bool = True
    embed_scale: bool = False            # gemma: scale embeds by sqrt(d)
    param_dtype: str = "float32"
    logit_dtype: str = "float32"
    supports_long_context: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    mixer: str                    # attn (the only mixer ported)
    attn: attention.AttnSpec
    ffn: str                      # swiglu | geglu | gelu | none


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError``, by ROADMAP item, for what the port has
    not ported yet."""
    mixers = set(cfg.mixer_pattern) - {"attn"}
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: mixers {sorted(mixers)} are not ported yet "
            "(ROADMAP Queue 1 item 10: SSM mixers)")
    if cfg.moe_period > 0 and cfg.moe_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1 "
            "item 10: MoE mixers)")
    if cfg.encoder_layers > 0 or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: encoders and modality frontends are not ported yet "
            "(ROADMAP Queue 1 item 10: encoder-decoder and multimodal)")
    if cfg.attn_shard_constraint is not None:
        raise NotImplementedError(
            f"{cfg.name}: attention sharding constraints are multi-device "
            "work, not ported yet (ROADMAP Queue 1 item 14)")


def _attn_spec(cfg: ModelConfig, i: int) -> attention.AttnSpec:
    sw = cfg.sliding_window
    if sw is not None and cfg.swa_period > 1 and i % cfg.swa_period != 0:
        sw = None                                  # global layer (gemma2 odd)
    chunk = cfg.chunk
    is_global_chunk = False
    if chunk is not None and cfg.chunk_period > 1 and \
            (i + 1) % cfg.chunk_period == 0:
        chunk = None                               # llama4 every 4th = global
        is_global_chunk = True
    use_rope = cfg.use_rope
    if cfg.nope_on_global and is_global_chunk:
        use_rope = False
    return attention.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
        sliding_window=sw, chunk=chunk, softcap=cfg.attn_softcap,
        causal=True, cross=False, use_rope=use_rope,
        rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
        use_flash=cfg.use_flash)


def layer_plan(cfg: ModelConfig) -> list[LayerPlan]:
    check_supported(cfg)
    return [LayerPlan(mixer="attn", attn=_attn_spec(cfg, i), ffn=cfg.ffn_kind)
            for i in range(cfg.num_layers)]
