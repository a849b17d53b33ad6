"""What the language-model drivers share: the program's configuration built
from the configuration's file, weights made on the device from the seed,
and leaf-by-leaf views of a weight tree."""

from __future__ import annotations

import math

import torch

from . import datasets

# the file's model keys and the program's ModelConfig fields they set
_FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
           "d_ff", "vocab_size", "sliding_window", "rope_theta",
           "tie_embeddings", "norm", "ffn_kind", "param_dtype")


def program_config(cfg: dict, *, kernels: bool):
    """The program's ``ModelConfig`` for the configuration's file: the
    program's own entry for the model with every size the file states set
    from the file.  ``kernels`` turns on the flash attention and RMSNorm
    kernels (serving; training refuses them)."""
    from repro_torch import configs

    model = cfg["model"]
    base = configs.get_config(cfg["program_name"])
    return base.scaled(use_flash=kernels, use_fused_norm=kernels,
                       **{k: model[k] for k in _FIELDS})


def shapes(model: dict) -> list:
    """(name, shape, std) of every weight, in the tree's order; std None
    marks a norm gain (stored as an offset from 1)."""
    d, h, kv, hd, ff, V = (model["d_model"], model["num_heads"],
                           model["num_kv_heads"], model["head_dim"],
                           model["d_ff"], model["vocab_size"])
    out = [("embed", (V, d), 1 / math.sqrt(d))]
    for i in range(model["num_layers"]):
        pre = f"layers.{i}."
        out += [(pre + "norm1.w", (d,), None),
                (pre + "attn.wq", (d, h * hd), 1 / math.sqrt(d)),
                (pre + "attn.wk", (d, kv * hd), 1 / math.sqrt(d)),
                (pre + "attn.wv", (d, kv * hd), 1 / math.sqrt(d)),
                (pre + "attn.wo", (h * hd, d), 1 / math.sqrt(h * hd)),
                (pre + "norm2.w", (d,), None),
                (pre + "ffn.w_gate", (d, ff), 1 / math.sqrt(d)),
                (pre + "ffn.w_up", (d, ff), 1 / math.sqrt(d)),
                (pre + "ffn.w_down", (ff, d), 1 / math.sqrt(ff))]
    out.append(("final_norm.w", (d,), None))
    if not model["tie_embeddings"]:
        out.append(("lm_head", (d, V), 1 / math.sqrt(d)))
    return out


def make_weights(model: dict, seed: int, device, gain_std: float = 0.1):
    """Every weight from one normal draw on the device: matrices scaled by
    1/sqrt(fan in), the embedding by 1/sqrt(d), norm gains small offsets
    from 1.  -> the program's dict tree (float32)."""
    spec = shapes(model)
    total = sum(math.prod(s) for _, s, _ in spec)
    flat = torch.randn(total, generator=datasets.generator(seed, device, 7),
                       device=device)
    tree: dict = {"layers": [dict() for _ in range(model["num_layers"])]}
    at = 0
    for name, shape, std in spec:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        leaf.mul_(gain_std if std is None else std)
        at += n
        _put(tree, name, leaf)
    return tree


def _put(tree, name: str, leaf) -> None:
    parts = name.split(".")
    node = tree
    for i, part in enumerate(parts[:-1]):
        node = node[int(part)] if part.isdigit() else node.setdefault(
            part, [] if parts[i + 1].isdigit() else {})
    node[parts[-1]] = leaf


def leaves(tree, prefix: str = "") -> list:
    """(dotted name, tensor) of every leaf of a dict/list tree."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return [map_tree(fn, v) for v in tree]
