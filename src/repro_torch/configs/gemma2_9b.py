"""gemma2-9b [dense] — alternating local/global attention + logit softcaps.

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
Source: Gemma 2 [arXiv:2408.00118].  head_dim=256 (independent of d_model),
4096-token sliding window on every other layer, attention softcap 50.0,
final-logit softcap 30.0, GeGLU MLPs, pre+post RMSNorm, sqrt(d) embedding
scaling.  Local layers bound the cache -> runs long_500k.
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    ffn_kind="geglu",
    post_norm=True,
    embed_scale=True,
    sliding_window=4096,
    swa_period=2,                  # even layers local, odd layers global
    attn_softcap=50.0,
    final_softcap=30.0,
    supports_long_context=True,
)
