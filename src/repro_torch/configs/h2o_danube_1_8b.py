"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Source: H2O-Danube-1.8B [arXiv:2401.16818] (mistral-style SWA).
Sliding window on all layers -> runs long_500k.
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    supports_long_context=True,
)
