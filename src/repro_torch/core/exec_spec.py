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
* ``scan`` — kept for the reference's spelling; the port has no compiled
  chunk path yet and ``runner.run`` refuses it.
* ``sampling`` — "host" (the ``np.random`` stream of the reference) or
  "device" (refused by ``runner.run`` until it is ported).
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
* ``mesh`` / ``shard`` — multi-device execution, not ported yet: any value
  other than ``None`` raises ``NotImplementedError``.

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
        if self.mesh is not None or self.shard is not None:
            raise NotImplementedError(
                "mesh= and shard= (multi-device execution) are not ported "
                "to PyTorch yet (ROADMAP Queue 1 item 14)")
        if self.sampling not in _SAMPLING:
            raise ValueError(f"sampling must be 'host' or 'device', got "
                             f"{self.sampling!r}")
        if self.kernel not in _KERNELS:
            raise ValueError(f"kernel must be 'plain', 'fused', or 'auto', "
                             f"got {self.kernel!r}")
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

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def replace(self, **kw) -> "ExecSpec":
        """A copy with the given fields changed (re-validated)."""
        return dataclasses.replace(self, **kw)
