"""PyTorch/CUDA port of the DPSVRG reproduction (``repro``), for NVIDIA
Hopper.

The layout mirrors the JAX package: ``core/`` (graphs, prox, SVRG, gossip,
algorithms, runner), ``data/``, ``configs/``, ``models/`` (the dense
decoder LMs), ``train/`` (the decentralized LM trainer), ``checkpoint/``,
``optim/``, ``serve/`` (continuous batching, consensus), ``launch/`` and
``kernels/`` (hand-written CUDA kernels, each beside its plain PyTorch
version).  The port imports
torch and numpy, never JAX and nothing of ``repro``.  Its entry points run
on the CUDA device unless the caller asks for the CPU
(``ExecSpec(device="cpu")``, ``device="cpu"``).
"""

from . import (checkpoint, configs, convert, core, data, kernels, launch,
               models, optim, serve, train)

__all__ = ["checkpoint", "configs", "convert", "core", "data", "kernels",
           "launch", "models", "optim", "serve", "train"]
