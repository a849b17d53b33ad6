"""Language-model building blocks of the port (``repro.models``): the
decoder stack of attention blocks with dense or MoE FFNs."""

from . import api, attention, common, ffn, moe, transformer

__all__ = ["api", "attention", "common", "ffn", "moe", "transformer"]
