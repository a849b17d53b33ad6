"""stablelm-12b [dense] — full-attention decoder with per-head QK norm.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
Source: [hf:stabilityai/stablelm-2-1_6b] family (StableLM-2 12B).
Pure full attention -> long_500k SKIPPED (`shape_applicable`).
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    norm="layernorm",
    qk_norm=True,
    tie_embeddings=False,
    supports_long_context=False,
)
