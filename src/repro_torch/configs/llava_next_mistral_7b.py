"""llava-next-mistral-7b [vlm] — anyres tiling; the vision tower is a stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
Source: [hf:llava-hf/llava-v1.6-mistral-7b-hf].  The vision tower and its
projector are out of scope; ``models.multimodal.fake_image_patches``
supplies precomputed anyres patch embeddings (tiles x 576 tokens), which
the backbone projects (``vision_proj``) and early-fuses as an image-token
prefix.  Mistral-7B-v0.2 base = full attention -> long_500k skipped.
"""

from ..models.api import ModelConfig
from ..models.multimodal import llava_image_tokens

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    frontend="vision_stub",
    image_tokens=llava_image_tokens(),   # anyres: tiles * 576 patches
    supports_long_context=False,
)
