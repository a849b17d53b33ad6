"""Language-model building blocks of the port (``repro.models``): decoder
stacks of attention, Mamba, mLSTM and sLSTM blocks with dense or MoE FFNs."""

from . import api, attention, common, ffn, moe, ssm, transformer

__all__ = ["api", "attention", "common", "ffn", "moe", "ssm", "transformer"]
