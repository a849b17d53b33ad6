"""Configurations of the port: the paper's logistic regression and the
language models, with the canonical input shapes.

The port of ``repro.configs``.  ``get_config(name)`` resolves ids with
dashes; ``smoke_variant`` produces the reduced CI model (2 layers,
d_model 128) used by the smoke tests.  The port has the config modules of
all ten architectures: the dense decoders (h2o-danube-1.8b, minicpm-2b,
gemma2-9b, stablelm-12b), the MoE ones (llama4-scout-17b-a16e,
llama4-maverick-400b-a17b), the recurrent xlstm-350m, the Mamba /
attention / MoE hybrid jamba-1.5-large-398b, the encoder-decoder
whisper-base and the image-prefix decoder llava-next-mistral-7b.
"""

from __future__ import annotations

import dataclasses
import importlib

from . import paper_logreg
from ..models.api import ModelConfig

__all__ = ["ARCHITECTURES", "INPUT_SHAPES", "InputShape", "get_config",
           "smoke_variant", "list_archs", "shape_applicable", "paper_logreg"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCHITECTURES = [
    "jamba-1.5-large-398b",
    "h2o-danube-1.8b",
    "llama4-maverick-400b-a17b",
    "stablelm-12b",
    "whisper-base",
    "xlstm-350m",
    "minicpm-2b",
    "llava-next-mistral-7b",
    "gemma2-9b",
    "llama4-scout-17b-a16e",
]


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    if arch not in ARCHITECTURES and arch != "paper_logreg":
        raise KeyError(f"unknown arch '{arch}'; have {ARCHITECTURES}")
    mod = importlib.import_module(f"{__name__}.{_module_name(arch)}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHITECTURES)


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether (arch, shape) is in the dry-run grid; reason when skipped.
    long_500k requires sub-quadratic context handling: pure full-attention
    archs skip it."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention architecture (no "
                       "sliding-window/chunked/recurrent path at 500k)")
    return True, ""


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    mha = cfg.num_kv_heads == cfg.num_heads
    return cfg.scaled(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4 if mha else 2,
        head_dim=None,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab_size=512,
        moe_experts=min(cfg.moe_experts, 4),
        sliding_window=None if cfg.sliding_window is None
        else min(cfg.sliding_window, 16),
        chunk=None if cfg.chunk is None else min(cfg.chunk, 16),
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 32) if cfg.encoder_seq else 0,
        image_tokens=min(cfg.image_tokens, 16) if cfg.image_tokens else 0,
        max_position=4096,
        scan_chunk=16,
    )
