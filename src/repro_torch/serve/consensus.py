"""Training -> serving bridge: consensus parameters from a trainer
checkpoint.  The port of ``repro.serve.consensus``.

The paper's deliverable is the *consensus* model — Theorem 1 bounds the
objective at the averaged iterate x̄ = (1/m) Σ_i x_i — but a
``train_loop(ckpt_dir=...)`` checkpoint stores the full decentralized
state: per-node parameter replicas stacked on a leading ``(m, ...)`` axis
(plus snapshot/full-gradient/transport state that serving does not need).
This module turns that artifact, written by either package, into the
thing you serve:

  params, info = consensus_params(ckpt_dir, cfg, device="cuda")

* ``params`` is the node-axis MEAN of the stacked replicas (formed in
  float64, then cast to ``cfg.param_dtype``) — unstacked tensors on
  ``device``, ready for ``transformer.prefill`` / ``decode_step`` / the
  serving engines,
* ``info`` reports the checkpoint step/algorithm and the per-node
  disagreement ‖x_i − x̄‖ (absolute and relative to ‖x̄‖).

``m`` (the node count) is inferred from the checkpoint's stacked embedding
table, so serving needs no knowledge of the training topology.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from .. import checkpoint as ckpt_lib
from ..models import transformer
from ..models.api import ModelConfig

__all__ = ["ConsensusInfo", "consensus_params"]

# trainer checkpoints store the TrainState NamedTuple, whose fields flatten
# as attribute paths: "state/.params/embed" etc.
_EMBED_KEY = "state/.params/embed"


class _ParamsOnly(NamedTuple):
    """Restore template mirroring TrainState's ``.params`` attribute path
    while omitting every other field (snapshot/full_grad/step/mix_state),
    which the template-driven reader then ignores."""
    params: Any


@dataclasses.dataclass(frozen=True)
class ConsensusInfo:
    step: int
    num_nodes: int
    algorithm: str | None
    node_dist: tuple            # per-node ‖x_i − x̄‖ over all leaves
    consensus_rel: float        # max_i ‖x_i − x̄‖ / ‖x̄‖

    def __str__(self):
        dists = ", ".join(f"{d:.3e}" for d in self.node_dist)
        return (f"consensus ckpt step={self.step} m={self.num_nodes} "
                f"algorithm={self.algorithm}: per-node ‖x_i − x̄‖ = "
                f"[{dists}] (max rel {self.consensus_rel:.3e})")


def _infer_num_nodes(ckpt_dir: str, step: int) -> int:
    shape = ckpt_lib.leaf_shape(
        os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"),
        _EMBED_KEY)
    if shape is None:
        raise ValueError(
            f"{ckpt_dir} step {step} has no '{_EMBED_KEY}' leaf — not a "
            f"train_loop checkpoint of a transformer LM")
    return int(shape[0])


def consensus_params(ckpt_dir: str, cfg: ModelConfig,
                     step: int | None = None, device="cuda"):
    """Load a ``train_loop`` checkpoint and average the node replicas.

    Returns ``(params, ConsensusInfo)`` with ``params`` an UNSTACKED tree
    in ``cfg``'s parameter dtype on ``device`` (the card unless the caller
    asks for the CPU).  Raises ``FileNotFoundError`` when ``ckpt_dir``
    holds no checkpoint and ``ValueError`` when the stored shapes do not
    match ``cfg``.
    """
    step = step if step is not None else ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    m = _infer_num_nodes(ckpt_dir, step)

    # the model's own parameters give the shapes and dtypes; each leaf is
    # overwritten with the consensus below, so nothing is allocated twice.
    # Only the stacked params are restored: the template-driven reader
    # ignores the other leaves (snapshot, full_grad, mix_state)
    params = transformer.init_params(cfg, 0, device=device)
    template = {"state": _ParamsOnly(params=pytree.tree_map(
        lambda x: torch.empty((m,) + tuple(x.shape), device="meta"),
        params))}
    tree, step, md = ckpt_lib.restore(ckpt_dir, template, step=step)
    leaves = pytree.tree_leaves(params)
    stacked = pytree.tree_leaves(tree["state"].params)

    # per-node disagreement over ALL leaves: d_i^2 = Σ_leaves ‖x_i − x̄‖²
    dev = leaves[0].device
    sq = torch.zeros(m, dtype=torch.float64, device=dev)
    norm_sq = torch.zeros((), dtype=torch.float64, device=dev)
    for out, leaf in zip(leaves, stacked):
        x = leaf.to(dev).to(torch.float64)
        mean = x.mean(dim=0)
        sq += (x - mean[None]).reshape(m, -1).square().sum(dim=1)
        norm_sq += mean.square().sum()
        out.copy_(mean)
    dist = torch.sqrt(sq).tolist()
    rel = max(dist) / max(float(norm_sq) ** 0.5, 1e-30)
    info = ConsensusInfo(step=int(step), num_nodes=m,
                         algorithm=md.get("algorithm"),
                         node_dist=tuple(dist), consensus_rel=rel)
    return params, info
