"""llama4-maverick-400b-a17b [moe] — 128-expert top-1 MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Source: [hf:meta-llama/Llama-4-Scout-17B-16E] family card.  Alternating
dense/MoE layers with a shared expert; iRoPE-style chunked-local attention
(every 4th layer global, NoPE on global layers) -> runs long_500k.
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe_experts=128,
    moe_top_k=1,
    moe_period=2,                  # alternating dense / MoE (maverick)
    moe_shared_expert=True,
    chunk=8192,
    chunk_period=4,                # every 4th layer global attention
    nope_on_global=True,
    rope_theta=500000.0,
    qk_norm=True,
    supports_long_context=True,
)
