"""One execution specification for ``runner.run``.

The port of ``repro.core.exec_spec``.  :class:`ExecSpec` packages every
execution choice as ONE immutable value::

    from repro_torch.core.exec_spec import ExecSpec
    runner.run(algo, problem, sched,
               ExecSpec(resident=True, kernel="fused", gossip="dense"))

Fields:

* ``resident`` — plan the run on the host, stage its inputs on the device
  in one transfer, and record metrics into device buffers that are pulled
  once at the end.  ``False`` is the host loop.
* ``scan`` — the chunked host path: each record window's steps are drawn
  on the host, staged in one transfer and run as the resident pieces
  (CUDA graphs on the card), with the records taken on the host.
* ``sampling`` — "host" (the ``np.random`` stream of the reference) or
  "device" (resident only): the minibatch indices are drawn on the device
  from a counter-based stream (``core.device_sampling``), and the plan
  stages step numbers instead of indices.
* ``device_transitions`` — fold outer-round transitions into the resident
  chunks ("auto" | True | False).
* ``kernel`` — the resident step: ``"plain"`` (unfused PyTorch step),
  ``"fused"`` (the fused resident-step kernel wherever a fused lowering
  exists) or ``"auto"`` (fused only at per-node sizes where it wins, see
  ``kernels.fused_update.ops.fused_wins``).
* ``gossip`` — transport backend name / instance / "auto".
* ``device`` — where the run executes, ``"cuda"`` by default.  A run asks
  for the CPU explicitly (``device="cpu"``); without a CUDA device and
  without that request, ``runner.run`` raises.
* ``mesh`` — a ``torch.distributed.device_mesh.DeviceMesh`` with named
  dims: enables the ``ppermute`` transport (a dim of size m, one node a
  rank) and carries the mesh for ``shard``.  Runs over a mesh are SPMD
  (``core.spmd``): every rank makes the same call.
* ``shard`` — ``None`` | ``"cells"`` (split a batched sweep's cells over
  the mesh's ``"cells"`` dim; ``run_sweep`` only) | ``"nodes"`` (split the
  stacked ``(m, ...)`` node axis of a resident run over the mesh, each rank
  holding its rows; ``runner.run`` only).  Both need ``resident=True``.
  The LM trainer takes ``"cells"`` in ``train_sweep`` and refuses
  ``"nodes"``, as the reference does; its sharded state is
  ``train_loop(mesh=, plan=)`` on the host loop.

Cross-field constraints are validated at construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ExecSpec"]

_SAMPLING = ("host", "device")
_KERNELS = ("plain", "fused", "auto")
_TRANSITIONS = ("auto", True, False)
_SHARDS = (None, "cells", "nodes")


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """How a run executes.  Defaults are the host loop on the card."""

    scan: bool = False
    resident: bool = False
    sampling: str = "host"
    device_transitions: Any = "auto"
    kernel: str = "plain"
    gossip: Any = "auto"
    mesh: Any = None
    shard: "str | None" = None
    device: Any = "cuda"

    def __post_init__(self):
        if self.sampling not in _SAMPLING:
            raise ValueError(f"sampling must be 'host' or 'device', got "
                             f"{self.sampling!r}")
        if self.kernel not in _KERNELS:
            raise ValueError(f"kernel must be 'plain', 'fused', or 'auto', "
                             f"got {self.kernel!r}")
        if self.shard not in _SHARDS:
            raise ValueError(f"shard must be None, 'cells', or 'nodes', "
                             f"got {self.shard!r}")
        if not any(self.device_transitions is t for t in _TRANSITIONS):
            raise ValueError(f"device_transitions must be 'auto', True, or "
                             f"False, got {self.device_transitions!r}")
        torch.device(self.device)    # raises on a malformed device string
        if self.sampling == "device" and not self.resident:
            raise ValueError("sampling='device' gathers minibatches inside "
                             "the resident chunks — it requires "
                             "resident=True")
        if self.device_transitions is True and not self.resident:
            raise ValueError("device_transitions folds outer rounds into "
                             "the resident chunks — it requires "
                             "resident=True")
        if self.kernel != "plain" and not self.resident:
            raise ValueError("kernel='fused'/'auto' swaps the fused step "
                             "into the resident chunks — it requires "
                             "resident=True")
        if self.shard is not None and not self.resident:
            raise ValueError(f"shard={self.shard!r} partitions the "
                             f"device-resident program over a mesh — it "
                             f"requires resident=True")

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def replace(self, **kw) -> "ExecSpec":
        """A copy with the given fields changed (re-validated)."""
        return dataclasses.replace(self, **kw)
