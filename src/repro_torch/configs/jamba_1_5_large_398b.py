"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave + MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts top-2.
Source: Jamba-1.5 [arXiv:2403.19887].  One attention layer per 8 (the rest
Mamba); MoE replaces the dense FFN on every other layer.  Sub-quadratic at
500k context (Mamba layers are O(L); attention decode is cache-linear).
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mixer_pattern=("attn",) + ("mamba",) * 7,   # 1:7 attn:mamba interleave
    moe_experts=16,
    moe_top_k=2,
    moe_period=2,                                # MoE every other layer
    mamba_d_state=16,
    mamba_expand=2,
    supports_long_context=True,
)
