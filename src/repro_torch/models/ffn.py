"""Feed-forward blocks: SwiGLU (llama family), GeGLU, plain GELU MLP.

The port of ``repro.models.ffn``.  GELU is the tanh approximation, as
``jax.nn.gelu`` computes it by default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common

__all__ = ["init_ffn", "ffn_forward"]


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32):
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": common.dense_init(gen, (d_model, d_ff), dtype),
            "w_up": common.dense_init(gen, (d_model, d_ff), dtype),
            "w_down": common.dense_init(gen, (d_ff, d_model), dtype),
        }
    if kind == "gelu":
        return {
            "w_up": common.dense_init(gen, (d_model, d_ff), dtype),
            "b_up": common.zeros_init((d_ff,), dtype, gen.device),
            "w_down": common.dense_init(gen, (d_ff, d_model), dtype),
            "b_down": common.zeros_init((d_model,), dtype, gen.device),
        }
    raise ValueError(f"unknown ffn kind {kind}")


def ffn_forward(params, x, kind: str):
    if kind == "swiglu":
        return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    if kind == "geglu":
        return (common.gelu(x @ params["w_gate"]) * (x @ params["w_up"])) \
            @ params["w_down"]
    if kind == "gelu":
        h = common.gelu(x @ params["w_up"] + params["b_up"])
        return h @ params["w_down"] + params["b_down"]
    raise ValueError(f"unknown ffn kind {kind}")
