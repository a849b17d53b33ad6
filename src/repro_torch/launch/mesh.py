"""Production meshes and the DPSVRG node mappings: the port of
``repro.launch.mesh``.

The reference's meshes are TPU v5e pods: ``(data=16, model=16)`` (256
chips) and ``(pod=2, data=16, model=16)`` (512 chips).  The port keeps
them as shapes (:func:`make_production_mesh`, a :class:`MeshShape` with no
devices), which the dry run counts on meta tensors, and builds a real
``DeviceMesh`` with named dims over the ranks of an initialized world
(:func:`make_mesh`, through ``core.spmd``).
"""

from __future__ import annotations

import dataclasses
import math

from ..train.sharding import MeshPlan

__all__ = ["MeshShape", "make_production_mesh", "make_mesh", "default_plan",
           "node_count", "PLANS"]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim names and sizes, without devices: ``shape`` is the
    reference's ``mesh.shape`` (``{name: size}``)."""
    names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod: (pod=2, data=16, model=16) = 512 chips."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_mesh(shape, names, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim ``names`` over every rank of
    the default group (started by ``spmd.spawn``), for tensors on
    ``device`` (the card unless the caller asks for the CPU).  The world
    must have exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..core import spmd
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    spmd.require_group(f"a mesh {dict(zip(names, shape))}")
    n, world = math.prod(shape), dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {world}: start {n} ranks "
            f"(spmd.spawn(fn, {n}, ...)) or pass a shape whose product is "
            f"the world's size")
    import torch
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


# DPSVRG node mappings (the reference's DESIGN.md §4):
#   paper-faithful  — one node per data-parallel rank (m = 16 per pod)
#   production      — one node per pod, DP+FSDP inside (m = 2; multi-pod only)
#   full            — every (pod, data) rank is a node (m = 32; multi-pod only)
PLANS = {
    ("single", "faithful"): MeshPlan(node_axes=("data",), fsdp_axes=()),
    ("multi", "faithful"): MeshPlan(node_axes=("pod", "data"), fsdp_axes=()),
    ("multi", "production"): MeshPlan(node_axes=("pod",), fsdp_axes=("data",)),
}


def default_plan(multi_pod: bool, mapping: str = "auto") -> MeshPlan:
    if mapping == "auto":
        mapping = "production" if multi_pod else "faithful"
    return PLANS[("multi" if multi_pod else "single", mapping)]


def node_count(mesh, plan: MeshPlan) -> int:
    """m: the product of the plan's node axes' sizes on ``mesh`` (a
    :class:`MeshShape` or a ``DeviceMesh``)."""
    shape = mesh.shape if isinstance(mesh, MeshShape) else \
        dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    m = 1
    for ax in plan.node_axes:
        m *= shape[ax]
    return m
