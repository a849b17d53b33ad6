"""whisper-base [audio] — encoder-decoder; the conv/mel frontend is a stub.

6L d_model=512 8H (kv=8, MHA) d_ff=2048 vocab=51865.
Source: Whisper [arXiv:2212.04356].  The backbone consumes precomputed
1500-frame encoder embeddings (``models.multimodal.fake_audio_frames``).
Learned positional embeddings (no RoPE), LayerNorm, GELU MLPs, a
cross-attention decoder.  long_500k skipped (an encoder-decoder of the
448-position decoder family).
"""

from ..models.api import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,                  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    ffn_kind="gelu",
    use_rope=False,
    max_position=65536,            # decode_32k is exercised mechanically
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio_stub",
    supports_long_context=False,
)
