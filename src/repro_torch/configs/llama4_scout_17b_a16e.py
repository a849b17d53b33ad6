"""llama4-scout-17b-a16e [moe] — 16-expert top-1 MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1.
Source: [hf:meta-llama/Llama-4-Scout-17B-16E].  MoE on every layer with a
shared expert; iRoPE chunked-local attention (every 4th layer global,
NoPE on global) -> runs long_500k.
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe_experts=16,
    moe_top_k=1,
    moe_period=1,                  # MoE every layer (scout)
    moe_shared_expert=True,
    chunk=8192,
    chunk_period=4,
    nope_on_global=True,
    rope_theta=500000.0,
    qk_norm=True,
    supports_long_context=True,
)
