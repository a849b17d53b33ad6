"""Conversion between the JAX package's stacked parameters (as numpy
arrays) and the port's tensors.

Both packages stack node parameters on a leading axis of size m and nest
them in the same dict / tuple / list structure, so a tree converts leaf by
leaf: ``params_from_numpy`` makes tensors on a device, ``params_to_numpy``
brings tensors back as numpy arrays.  The parity tests feed both packages
through these.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device):
    """numpy (or array-like) leaves -> tensors on ``device``, same dtype."""
    return pytree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree):
    """tensor leaves -> numpy arrays on the host, same dtype."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), tree)
