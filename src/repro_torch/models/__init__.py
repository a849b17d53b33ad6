"""Language-model building blocks of the port (``repro.models``): the
dense decoder stack of attention blocks with dense FFNs."""

from . import api, attention, common, ffn, transformer

__all__ = ["api", "attention", "common", "ffn", "transformer"]
