"""Parameter / batch / cache sharding specs: the port of
``repro.train.sharding``.

``MeshPlan`` declares how a mesh's dims are used:

  node_axes  — dims whose product is the DPSVRG node count m (the stacked
               leading parameter axis is laid out over them),
  model_axis — tensor-parallel dim for weight matrices / heads / experts,
  fsdp_axes  — dims that additionally shard large weight dims (classic
               FSDP; used when ``data`` is *not* a node axis, i.e. the
               nodes-=-pods production mapping).

A spec is a plain tuple with one entry a dimension: ``None``
(replicated), a mesh dim's name, or a tuple of names (sharded over their
product): the reference's ``PartitionSpec`` read as a tuple, so
``tuple(P(...))`` equals the port's spec.  Specs are derived by
name-and-shape rules over the parameter tree, so any architecture in the
zoo (attention, MoE experts, Mamba, xLSTM, enc-dec) shards without
per-model annotations.  :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
import math

from torch.utils import _pytree as pytree

__all__ = ["MeshPlan", "param_specs", "batch_spec", "cache_specs",
           "stacked_specs", "placements", "place", "shard_slices",
           "shard_shape", "spec_axes"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    node_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp_axes: tuple = ()
    # leaves smaller than this stay replicated across fsdp axes
    fsdp_min_size: int = 1 << 16


# weight-name -> which dim carries the "parallel" (model-axis) dimension,
# counted over the *unstacked* leaf.  3-D expert weights shard dim0 = E.
_DIM1_MODEL = {
    "wq", "wk", "wv", "w_gate", "w_up", "in_proj", "up_proj", "dt_proj",
    "ffn_up", "w_gates", "shared_gate", "shared_up", "lm_head",
}
_DIM0_MODEL = {
    "wo", "w_down", "out_proj", "down_proj", "x_proj", "ffn_down",
    "shared_down", "embed", "a_log",
}
_LAST_DIM_MODEL = {"conv_w"}           # (width, d_inner)
_REPLICATED = {
    "router", "b_gates", "r_gates", "w_if", "b_i", "b_f", "norm_w", "skip_w",
    "conv_b", "dt_bias", "d_skip", "w", "b", "b_up", "b_down", "q_norm",
    "k_norm", "pos_embed", "vision_proj",
}


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, pytree.MappingKey):
            return str(entry.key)
    return ""


def _under_moe(path) -> bool:
    return any(isinstance(e, pytree.MappingKey) and e.key == "moe"
               for e in path)


def _axes_size(axis_sizes, axes) -> int:
    if axis_sizes is None:
        return 1
    if not isinstance(axes, tuple):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= int(axis_sizes.get(a, 1))
    return n


def _divides(axis_sizes, axes, dim_size: int) -> bool:
    """True when sharding ``dim_size`` over ``axes`` is exact (without
    ``axis_sizes`` every split counts as exact, as in the reference)."""
    if axis_sizes is None:
        return True
    return dim_size % _axes_size(axis_sizes, axes) == 0


def _one_or_tuple(axes: tuple):
    return axes if len(axes) > 1 else axes[0]


def _base_spec(path, shape: tuple, plan: MeshPlan, axis_sizes=None,
               attn_dim0: bool = False) -> list:
    """Spec entries of an *unstacked* leaf of ``shape`` (no node axes).

    Preference order per rule with divisibility-aware fallback to the other
    dim (vocab sizes like 51865/122753 and xLSTM's 4/3 ratios are not
    divisible by 16; the alternate dim usually is).

    ``attn_dim0`` (decode plan): shard q/k/v projections over d_model (the
    contraction dim) instead of heads, and wo over its OUTPUT dim."""
    name = _leaf_name(path)
    nd = len(shape)
    spec: list = [None] * nd
    ma = plan.model_axis

    def try_dims(*dims):
        for d in dims:
            if d < nd and _divides(axis_sizes, ma, shape[d]):
                spec[d] = ma
                return

    if nd == 0 or name in _REPLICATED:
        pass
    elif _under_moe(path) and nd == 3:
        try_dims(0, 2, 1)                  # experts, then ff, then d
    elif attn_dim0 and name in ("wq", "wk", "wv") and nd >= 2:
        try_dims(0, 1)
    elif attn_dim0 and name == "wo" and nd >= 2:
        try_dims(1, 0)
    elif name in _DIM1_MODEL and nd >= 2:
        try_dims(1, 0)
    elif name in _DIM0_MODEL and nd >= 2:
        try_dims(0, 1)
    elif name in _LAST_DIM_MODEL and nd >= 2:
        try_dims(nd - 1)
    elif name in _DIM0_MODEL and nd == 1:
        try_dims(0)
    # FSDP: shard the largest still-unassigned divisible dim of big leaves
    if plan.fsdp_axes and math.prod(shape) >= plan.fsdp_min_size and nd >= 2:
        fa = _one_or_tuple(plan.fsdp_axes)
        free = sorted((i for i in range(nd) if spec[i] is None),
                      key=lambda j: -shape[j])
        for i in free:
            if _divides(axis_sizes, fa, shape[i]):
                spec[i] = fa
                break
    return spec


def param_specs(params, plan: MeshPlan, stacked: bool = False,
                axis_sizes=None, attn_dim0: bool = False):
    """Spec tree for params (tensors, meta tensors or anything with a
    ``shape``).  ``stacked=True`` prefixes the node axes over the leading
    stacked dimension.  ``axis_sizes`` (mesh dim -> size) enables the
    divisibility checks and their fallbacks."""
    prefix = [_one_or_tuple(plan.node_axes)] if stacked else []

    def spec(path, leaf):
        base = _base_spec(path, tuple(leaf.shape)[len(prefix):], plan,
                          axis_sizes, attn_dim0=attn_dim0)
        return tuple(prefix + base)

    return pytree.tree_map_with_path(spec, params)


def batch_spec(plan: MeshPlan, ndim: int, stacked: bool = True,
               shape=None, axis_sizes=None) -> tuple:
    """Batch leaves: (m, per_node_batch, ...) -> (node_axes, fsdp_axes,
    ...).  The per-node batch dim is sharded over the fsdp axes
    (within-node data parallelism); remaining dims replicated.  Dims that
    do not divide the axis size stay replicated (when ``shape`` and
    ``axis_sizes`` are given)."""
    spec: list = [None] * ndim
    i = 0
    na = _one_or_tuple(plan.node_axes)
    if stacked:
        if shape is None or _divides(axis_sizes, na, shape[0]):
            spec[0] = na
        i = 1
    if plan.fsdp_axes and ndim > i:
        fa = _one_or_tuple(plan.fsdp_axes)
        if shape is None or _divides(axis_sizes, fa, shape[i]):
            spec[i] = fa
    return tuple(spec)


def stacked_specs(tree, plan: MeshPlan):
    """Specs for optimizer/SVRG state with the same layout as stacked
    params."""
    return param_specs(tree, plan, stacked=True)


def cache_specs(cache, plan: MeshPlan, batch_axis: str = "data",
                axis_sizes=None):
    """Serving-cache specs: batch dim over ``batch_axis`` (when divisible;
    a batch of 1 stays replicated); the model axis goes on KV heads /
    recurrent-state dims with divisibility fallbacks (GQA kv=8 on a
    model=16 axis falls back to sequence sharding, flash-decoding style,
    or head_dim)."""
    ma = plan.model_axis

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0 or name == "pos":
            return ()
        s: list = [None] * nd

        def try_dims(*dims):
            for d in dims:
                if d < nd and s[d] is None and \
                        _divides(axis_sizes, ma, shape[d]):
                    s[d] = ma
                    return

        if _divides(axis_sizes, batch_axis, shape[0]):
            s[0] = batch_axis
        if name in ("k", "v") and nd == 4:
            try_dims(2, 1, 3)               # kv heads, else seq, else hd
        elif name == "h" and nd == 3:
            try_dims(1)                     # mamba d_inner
        elif name == "conv" and nd == 3:
            try_dims(2)
        elif name == "c" and nd == 4:
            try_dims(1, 2)                  # mlstm heads, else hd
        elif name == "n" and nd == 3:
            try_dims(1, 2)
        return tuple(s)

    return pytree.tree_map_with_path(spec, cache)


# ---------------------------------------------------------------------------
# Specs on a mesh
# ---------------------------------------------------------------------------

def spec_axes(entry) -> tuple:
    """The mesh dims one spec entry names (``()`` for replicated)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec, axis_sizes: dict) -> tuple:
    """The largest rank's shard of a leaf of ``shape`` under ``spec``:
    each dimension split over the product of its dims' sizes, rounded up
    (an exact split is the even one); a spec shorter than the shape
    leaves the rest whole, as a ``PartitionSpec`` does."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _axes_size(axis_sizes, spec_axes(e)))
                 for n, e in zip(shape, spec))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` with
    named dims): ``Shard(d)`` on each mesh dim that dimension ``d`` names,
    ``Replicate()`` on the others.  A dimension over several mesh dims is
    split over them in mesh order (GSPMD splits it in the spec's order,
    which is the mesh's order on every plan of ``launch.mesh``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names mesh dim {a!r}, which "
                                 f"the mesh {names} has not")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shard_slices(x, mesh=None, placements=None) -> tuple:
    """The slices of the whole value that this rank's shard holds: of the
    DTensor ``x``, or of a tensor of ``x``'s shape placed so on
    ``mesh``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if mesh is None:
        mesh, placements = x.device_mesh, x.placements
    shape, offset = compute_local_shape_and_global_offset(
        tuple(x.shape), mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def place(x, mesh, placements):
    """The DTensor on ``mesh`` with ``placements`` whose whole value is
    ``x`` (a tensor every rank holds whole): each rank keeps its own shard,
    cut from ``x`` without any exchange (a host ``x`` of a mesh on the
    card moves only the shard there)."""
    from ..models.placed import wrap
    local = x[shard_slices(x, mesh, placements)]
    # a shard is its own memory, so that the whole value can be freed
    if local.device.type != mesh.device_type:
        local = local.to(mesh.device_type)
    elif local.numel() < x.numel():
        local = local.clone()
    return wrap(local, mesh, placements, x.shape)
