"""minicpm-2b [dense] — llama-like with depth-scaled residuals.

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
Source: MiniCPM [arXiv:2404.06395].
Pure full attention -> long_500k SKIPPED.
"""

from ..models.api import ModelConfig

# MiniCPM scale_depth = 1.4: residual branches scaled by 1.4 / sqrt(L)
_RESIDUAL_SCALE = 1.4 / (40 ** 0.5)

CONFIG = ModelConfig(
    name="minicpm-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    residual_scale=_RESIDUAL_SCALE,
    supports_long_context=False,
)
