"""Step builders of the decentralized LM trainer (DPSVRG / DSPG) and of
serving (prefill / decode).  The port of ``repro.train.steps`` on one
device.

This is where the paper's algorithm becomes the data-parallel training
rule for the model zoo:

  * parameters are *stacked* per node (leading axis m); the per-node loss
    and gradient are ``torch.func.vmap(torch.func.grad_and_value(loss))``
    over that axis, the counterpart of the reference's
    ``jax.vmap(jax.value_and_grad(loss))``: each node's gradient is its
    own, computed by one batched program for all m nodes,
  * the SVRG correction uses the per-node snapshot + large-batch "full"
    gradient state,
  * gossip is the host-precomputed multi-consensus matrix, applied by the
    transport's wire format (``compression.mix_with_state``),
  * the prox step is the regularizer's closed form.

The step runs the plain model path: the RMSNorm and flash attention
kernels have no backward (the reference cannot differentiate its Pallas
kernels either), so ``train_loop`` refuses configs that turn them on.

**Sharded state** (``plan=`` and ``mesh=``, a ``DeviceMesh`` with named
dims, every rank making the same call; ``core.spmd``), the counterpart of
the reference's GSPMD shardings:

  * the stacked node axis is split over the plan's node axes (one mesh
    dim, or several flattened pod major) in contiguous blocks, ``m / size``
    rows a rank (``spmd.node_axis``), and
    the mix runs over the wire (``gossip.shard_phi``: ``GatheredPhi`` or
    ``PermutePhi``) on each rank's local shards;
  * each leaf of the rank's rows is a DTensor on the submesh of the other
    dims (the model and FSDP axes), placed by ``sharding.param_specs(
    stacked=True)``; the batch's per-node dim is split over the FSDP axes
    (``sharding.batch_spec``).  The model runs on them with its local
    regions (``models.placed``); the SVRG direction and the prox run on
    the DTensors;
  * the per-node gradient is one ``torch.autograd.grad`` a row of the
    rank's rows, where the unsharded step vmaps ``torch.func.grad``: under
    ``torch.func``'s transforms a DTensor is hidden inside the transform's
    wrapper, so the model's local regions cannot see it, and DTensor's
    sharding propagation cannot carry the model's gradient by itself
    (a vocab-split lookup's masked partial sum loses its mask).  The rows'
    gradients are the vmapped ones, computed one node at a time.

``TrainBundle.gather`` turns a sharded state's tree into the whole
stacked tensors on every rank (an all-gather over each dim), and
``ServeBundle.place_params`` places serving weights by the unstacked
specs; sharded prefill and decode take placed tokens and caches
(``cache_shardings``).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..core import algorithm as algo_lib, compression, gossip, \
    prox as prox_lib, spmd, svrg
from ..models import placed, transformer
from ..models.api import ModelConfig
from ..spans import span
from . import sharding

__all__ = ["TrainBundle", "ServeBundle", "build_train_step",
           "build_serve_steps", "make_stacked_init", "TrainState"]


class TrainState(NamedTuple):
    """The reference's five fields, so checkpoint keys match
    (``state/.params/...``, ``state/.step``)."""
    params: Any            # stacked (m, ...)
    snapshot: Any          # stacked (m, ...)
    full_grad: Any         # stacked (m, ...)
    step: torch.Tensor     # int32 scalar
    # transport state for stateful gossip (compressed error feedback);
    # None for stateless wire formats
    mix_state: Any = None


class TrainBundle(NamedTuple):
    train_step: Callable     # (state, batch, phi, alpha) -> (state, metrics)
    snapshot_step: Callable  # (state, big_batch) -> state
    init_state: Callable     # (seed, device) -> state
    loss_fn: Callable
    # sharded: the TrainState of each leaf's DTensor placements, a function
    # of a (whole, stacked) batch giving its leaves' placements a row, the
    # rank's placed rows of a whole stacked params-shaped tree (or of its
    # rows alone), and the whole stacked tensors of one (every rank's; with
    # ``dst=r``, host tensors on global rank r only, None on the others);
    # None / identity unsharded
    state_shardings: Any = None
    batch_shardings: Callable = lambda batch: None
    place: Callable = lambda tree: tree
    gather: Callable = lambda tree, dst=None: tree
    rows: slice = slice(None)    # the rank's rows of the stacked nodes


class ServeBundle(NamedTuple):
    prefill_step: Callable
    decode_step: Callable
    init_params: Callable    # (seed, device) -> params
    # sharded: each weight's placements, the cache's (a function of the
    # cache), and the weights placed by them; None / identity unsharded
    param_shardings: Any = None
    cache_shardings: Callable = lambda cache: None
    place_params: Callable = lambda params: params


def _check_mesh(plan, mesh) -> bool:
    """Whether the step is sharded: ``plan`` and ``mesh`` together."""
    if (plan is None) != (mesh is None):
        raise ValueError(
            "sharded state needs both plan= (a sharding.MeshPlan) and mesh= "
            "(a DeviceMesh with named dims); got only "
            + ("plan" if mesh is None else "mesh"))
    return mesh is not None


def _replicating(on: bool):
    """The placed model runs with its plain tensors (positions, masks)
    taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication() if on else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Decentralized training
# ---------------------------------------------------------------------------

def make_stacked_init(cfg: ModelConfig, m: int):
    """All nodes start from the same point (Algorithm 1 line 2).  Returns
    ``init(seed, device)`` -> params stacked (m, ...), each node's copy its
    own memory."""

    def init(seed, device="cuda"):
        params = transformer.init_params(cfg, seed, device=device)
        return pytree.tree_map(
            lambda x: x[None].expand((m,) + x.shape).clone(), params)

    return init


# Rebuilt bundles with identical (cfg, prox, m, rule) are served from this
# cache, so their step identities stay stable across train_loop calls, as
# the reference's are.  Keyed on the frozen-dataclass equality of cfg/prox.
_BUNDLE_CACHE: "collections.OrderedDict[tuple, TrainBundle]" = \
    collections.OrderedDict()
_BUNDLE_CACHE_MAX = 16


def build_train_step(cfg: ModelConfig,
                     prox: prox_lib.Prox,
                     m: int,
                     plan=None,
                     mesh=None,
                     algorithm: "str | algo_lib.UpdateRule" = "dpsvrg"
                     ) -> TrainBundle:
    """``algorithm``: an ``UpdateRule`` from ``repro_torch.core.algorithm``
    (or its registry name: dpsvrg | dspg).  The LM train step is the SAME
    prox-gossip update the logistic-regression runner executes
    (``algo_lib.prox_gossip_update`` with the rule's gradient direction).

    The train step's ``phi`` is any wire format the transports produce: a
    dense ``(m, m)`` matrix, a ``gossip.BandedPhi`` or a
    ``compression.CompressedPhi`` (whose error feedback threads through
    ``TrainState.mix_state``), its leaves on the state's device.  With
    ``plan=`` and ``mesh=`` the state is sharded (see the module's
    docstring); a phi over the whole stack is applied over the wire."""
    rule = (algo_lib.UPDATE_RULES[algorithm] if isinstance(algorithm, str)
            else algorithm)
    if _check_mesh(plan, mesh):
        return _build_sharded_step(cfg, prox, m, plan, mesh, rule)
    try:
        cache_key = (cfg, prox, m, rule)
        cached = _BUNDLE_CACHE.get(cache_key)
    except TypeError:                # unhashable custom cfg/prox: just build
        cache_key, cached = None, None
    if cached is not None:
        _BUNDLE_CACHE.move_to_end(cache_key)
        return cached
    bundle = _build_train_step(cfg, prox, m, rule)
    if cache_key is not None:
        _BUNDLE_CACHE[cache_key] = bundle
        while len(_BUNDLE_CACHE) > _BUNDLE_CACHE_MAX:
            _BUNDLE_CACHE.popitem(last=False)
    return bundle


def _build_train_step(cfg, prox, m, rule) -> TrainBundle:
    loss = transformer.loss_fn(cfg)
    grad_and_loss = torch.func.vmap(torch.func.grad_and_value(loss))
    grad_only = torch.func.vmap(torch.func.grad(loss))

    def train_step(state: TrainState, batch, phi, alpha):
        with span("train.grad"):
            g_now, losses = grad_and_loss(state.params, batch)
            g_snap = grad_only(state.snapshot, batch) \
                if rule.needs_snapshot else None
        v = rule.direction(g_now, g_snap, state.full_grad)
        del g_now, g_snap          # free the gradients before the update
        v_norm = svrg.tree_norm(v)

        # the mix threads the transport state (compressed error feedback)
        # via the dispatching mix_with_state; for stateless wire formats it
        # is gossip.mix_stacked and the state (None) passes through
        mix_out = {}

        def mix_fn(phi_, tree):
            mixed, mix_out["state"] = compression.mix_with_state(
                phi_, tree, state.mix_state)
            return mixed

        with span("train.mix"):
            new_params = algo_lib.prox_gossip_update(state.params, v, phi,
                                                     alpha, prox,
                                                     mix_fn=mix_fn)
        metrics = {"loss": torch.mean(losses), "v_norm": v_norm}
        return state._replace(params=new_params, step=state.step + 1,
                              mix_state=mix_out["state"]), metrics

    def snapshot_step(state: TrainState, big_batch):
        """Outer loop: refresh snapshot + (large-batch) full local gradient."""
        mu = grad_only(state.params, big_batch)
        return state._replace(snapshot=state.params, full_grad=mu)

    def init_state(seed, device="cuda"):
        params = make_stacked_init(cfg, m)(seed, device)
        zeros = pytree.tree_map(torch.zeros_like, params)
        step = torch.zeros((), dtype=torch.int32,
                           device=pytree.tree_leaves(params)[0].device)
        return TrainState(params=params, snapshot=params, full_grad=zeros,
                          step=step)

    return TrainBundle(train_step=train_step, snapshot_step=snapshot_step,
                       init_state=init_state, loss_fn=loss)


class _Layout(NamedTuple):
    """Where a sharded step's state lives: the node axis of ranks, the
    submesh of the other dims (None when the node axis is the whole
    mesh), their sizes, the node dim's own mesh, and the wire."""
    axis: spmd.NodeAxis
    sub: Any
    axis_sizes: dict
    node_mesh: Any
    wire: str          # the placed tensors' wire (spmd.placed_wire)


def node_layout(mesh, plan: sharding.MeshPlan, m: int) -> _Layout:
    """The node axis of ``plan`` on ``mesh`` and the submesh of the other
    dims.  Node axes of several mesh dims (the ("multi", "faithful") plan's
    ``("pod", "data")``) lie over their product, a rank's node block
    row-major over them, pod major (``spmd.node_mesh``): the order of the
    reference's ``P(("pod", "data"), ...)``."""
    nodes = tuple(plan.node_axes)
    node_mesh = spmd.node_mesh(mesh, nodes)      # raises on a missing dim
    rest = tuple(n for n in mesh.mesh_dim_names if n not in nodes)
    return _Layout(axis=spmd.node_axis(node_mesh,
                                       node_mesh.mesh_dim_names[0], m),
                   sub=mesh[rest] if rest else None,
                   axis_sizes=spmd.mesh_shape(mesh), node_mesh=node_mesh,
                   wire=spmd.placed_wire(mesh))


def _sub_placements(layout: _Layout, spec: tuple):
    """Placements on the submesh of a stacked spec (its node entry, which
    the rows carry, dropped)."""
    if layout.sub is None:
        return None
    return sharding.placements((None,) + tuple(spec[1:]), layout.sub)


def _place_rows(layout: _Layout, x: torch.Tensor, pl):
    """The rank's rows of a whole stacked leaf, or those rows alone (as
    ``checkpoint.restore(rows=)`` reads them), placed on the submesh: its
    own memory, on the mesh's device (a leaf on the host moves only the
    rank's part)."""
    ax = layout.axis
    rows = x[ax.rows] if x.shape[0] == ax.m else x
    if rows.shape[0] != ax.rows.stop - ax.rows.start:
        raise ValueError(f"a stacked leaf of {x.shape[0]} rows is neither "
                         f"the {ax.m} nodes nor this rank's "
                         f"{ax.rows.stop - ax.rows.start}")
    if pl is not None:
        return sharding.place(rows, layout.sub, pl)
    device = layout.node_mesh.device_type
    return rows.clone() if rows.device.type == device else rows.to(device)


def _local(x):
    return x.to_local() if placed.is_placed(x) else x


def _rewrap(like, local):
    """``local`` as the shard of a DTensor laid out as ``like``."""
    if not placed.is_placed(like):
        return local
    return placed.wrap(local, like.device_mesh, like.placements, like.shape)


def _build_sharded_step(cfg, prox, m, plan, mesh, rule) -> TrainBundle:
    layout = node_layout(mesh, plan, m)
    ax = layout.axis
    loss = transformer.loss_fn(cfg)
    shapes = make_stacked_init(cfg, m)(0, "meta")
    specs = sharding.param_specs(shapes, plan, stacked=True,
                                 axis_sizes=layout.axis_sizes)
    pls = pytree.tree_map(lambda sp: _sub_placements(layout, sp), specs,
                          is_leaf=lambda x: isinstance(x, tuple))

    def pinned(tree):
        """``tree`` (params-shaped) on the specs' placements, as the
        reference's ``out_shardings=state_shardings`` pins its state: an
        update's DTensors come out wherever sharding propagation put them
        (a gradient's placements follow its backward), and a state whose
        layout drifted would round otherwise than one restored from a
        checkpoint by the specs."""
        return pytree.tree_map(
            lambda x, pl: x if pl is None or tuple(x.placements) == tuple(pl)
            else x.redistribute(x.device_mesh, pl), tree, pls,
            is_leaf=lambda x: x is None or isinstance(x, torch.Tensor))

    def batch_shardings(batch):
        return pytree.tree_map(lambda leaf: _sub_placements(
            layout, sharding.batch_spec(plan, leaf.ndim, shape=leaf.shape,
                                        axis_sizes=layout.axis_sizes)),
            batch)

    def row_grads(params, batch, want_loss: bool):
        """Each of the rank's rows' gradient (and loss), stacked."""
        bpl = batch_shardings(batch)
        rows = pytree.tree_map(
            lambda x, pl: _place_rows(layout, x, pl), batch, bpl,
            is_leaf=lambda x: x is None or isinstance(x, torch.Tensor))
        grads, losses = [], []
        for i in range(m // ax.size):
            p_i = pytree.tree_map(
                lambda x: x[i].detach().requires_grad_(True), params)
            b_i = pytree.tree_map(lambda x: x[i], rows)
            leaves, tdef = pytree.tree_flatten(p_i)
            with torch.enable_grad(), _replicating(layout.sub is not None):
                li = loss(p_i, b_i)
                grads.append(pytree.tree_unflatten(
                    list(torch.autograd.grad(li, leaves)), tdef))
            losses.append(_full(li.detach()))
            del p_i, leaves
        g = pytree.tree_map(lambda *xs: torch.stack(xs), *grads)
        return g, (torch.stack(losses) if want_loss else None)

    def whole_rows(x):
        """All m rows of a node-sharded vector of the rank's rows."""
        return spmd.all_gather_rows(x, ax)

    def tree_norm(tree):
        """``svrg.tree_norm`` over every node: each leaf's squared norm over
        the rank's rows, summed over the node axis in one exchange."""
        sq = torch.stack([_full(torch.linalg.vector_norm(leaf)) ** 2
                          for leaf in pytree.tree_leaves(tree)])
        sq = spmd.all_reduce_sum(sq, ax.group)
        return torch.linalg.vector_norm(torch.sqrt(sq))

    def train_step(state: TrainState, batch, phi, alpha):
        g_now, losses = row_grads(state.params, batch, True)
        g_snap = row_grads(state.snapshot, batch, False)[0] \
            if rule.needs_snapshot else None
        v = rule.direction(g_now, g_snap, state.full_grad)
        del g_now, g_snap
        v_norm = tree_norm(v)
        wire_phi = gossip.shard_phi(phi, layout.node_mesh, ax.axis)
        mix_out = {}

        def mix_fn(phi_, tree):
            # the mix crosses the node axis only: each rank exchanges its
            # local shards with the ranks that hold the same shards of the
            # other nodes' rows
            tree = pinned(tree)
            mixed, mix_out["state"] = compression.mix_with_state(
                phi_, pytree.tree_map(_local, tree), state.mix_state)
            return pytree.tree_map(_rewrap, tree, mixed)

        new_params = algo_lib.prox_gossip_update(
            state.params, v, wire_phi, alpha, prox, mix_fn=mix_fn)
        metrics = {"loss": torch.mean(whole_rows(losses)), "v_norm": v_norm}
        return state._replace(params=new_params, step=state.step + 1,
                              mix_state=mix_out["state"]), metrics

    def snapshot_step(state: TrainState, big_batch):
        mu = pinned(row_grads(state.params, big_batch, False)[0])
        return state._replace(snapshot=state.params, full_grad=mu)

    def init_state(seed, device="cuda"):
        params = pytree.tree_map(
            lambda x, pl: _place_rows(layout, x[None].expand(
                (m,) + x.shape), pl),
            transformer.init_params(cfg, seed, device=device), pls,
            is_leaf=lambda x: x is None or isinstance(x, torch.Tensor))
        zeros = pytree.tree_map(torch.zeros_like, params)
        step = torch.zeros((), dtype=torch.int32,
                           device=_local(pytree.tree_leaves(params)[0]).device)
        return TrainState(params=params, snapshot=params, full_grad=zeros,
                          step=step)

    def place(tree):
        return pytree.tree_map(lambda x, pl: _place_rows(layout, x, pl),
                               tree, pls, is_leaf=lambda x: x is None
                               or isinstance(x, torch.Tensor))

    def gathered_to(x, dst: int):
        """The whole stacked leaf on the host of global rank ``dst`` (None
        on the others): each rank's shard goes there once, through the
        host over gloo (over NCCL, on the card, then to the host)."""
        dist = spmd.dist
        nccl = dist.get_backend() == "nccl"
        local = _local(x).detach().contiguous()
        local = local if nccl else local.cpu()
        sl = (ax.rows,) + (sharding.shard_slices(x)[1:]
                           if placed.is_placed(x) else ())
        mine = dist.get_rank() == dst
        parts = [torch.empty_like(local) for _ in range(
            dist.get_world_size())] if mine else None
        dist.gather(local, parts, dst=dst)
        slices = [None] * dist.get_world_size() if mine else None
        dist.gather_object(sl, slices, dst=dst)
        if not mine:
            return None
        whole = torch.empty((m,) + tuple(x.shape[1:]), dtype=local.dtype)
        for part, where in zip(parts, slices):
            whole[where] = part.cpu()
        return whole

    def gather(tree, dst: int | None = None):
        if dst is not None:
            return pytree.tree_map(lambda x: gathered_to(x, dst), tree)
        return pytree.tree_map(lambda x: whole_rows(_full(x)), tree)

    return TrainBundle(
        train_step=train_step, snapshot_step=snapshot_step,
        init_state=init_state, loss_fn=loss,
        state_shardings=TrainState(params=pls, snapshot=pls, full_grad=pls,
                                   step=None),
        batch_shardings=batch_shardings, place=place, gather=gather,
        rows=ax.rows)


def _full(x):
    """A DTensor's whole value (the rank's rows of the node axis)."""
    return x.full_tensor() if placed.is_placed(x) else x


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def build_serve_steps(cfg: ModelConfig, plan=None, mesh=None) -> ServeBundle:
    """Prefill and decode steps.  With ``plan=`` and ``mesh=`` the weights
    are placed by ``sharding.param_specs`` (``place_params``), a step's
    tokens and modality inputs are split over the mesh's ``"data"`` dim
    where the batch divides it (the reference's serving inputs), and the
    cache comes back placed by ``sharding.cache_specs``; logits come back
    as DTensors (``full_tensor()`` gives them whole)."""

    def init_params(seed, device="cuda"):
        return transformer.init_params(cfg, seed, device=device)

    if not _check_mesh(plan, mesh):
        def prefill_step(params, tokens, image_embeds=None,
                         audio_frames=None, max_len=None):
            return transformer.prefill(cfg, params, tokens,
                                       image_embeds=image_embeds,
                                       audio_frames=audio_frames,
                                       max_len=max_len)

        def decode_step(params, cache, token):
            return transformer.decode_step(cfg, params, cache, token)

        return ServeBundle(prefill_step=prefill_step,
                           decode_step=decode_step, init_params=init_params)

    from torch.distributed.tensor.experimental import implicit_replication
    spmd.placed_wire(mesh)
    axis_sizes = spmd.mesh_shape(mesh)
    pspecs = sharding.param_specs(transformer.init_params(cfg, 0, "meta"),
                                  plan, axis_sizes=axis_sizes)
    param_shardings = pytree.tree_map(
        lambda sp: sharding.placements(sp, mesh), pspecs,
        is_leaf=lambda x: isinstance(x, tuple))

    def cache_shardings(cache):
        specs = sharding.cache_specs(cache, plan, axis_sizes=axis_sizes)
        return pytree.tree_map(lambda sp: sharding.placements(sp, mesh),
                               specs, is_leaf=lambda x: isinstance(x, tuple))

    def place_params(params):
        return pytree.tree_map(
            lambda x, pl: sharding.place(x, mesh, pl), params,
            param_shardings)

    def place_inputs(x):
        """A batch-leading input, split over "data" where it divides."""
        if x is None or placed.is_placed(x):
            return x
        data = "data" if "data" in axis_sizes and \
            x.shape[0] % axis_sizes["data"] == 0 else None
        return sharding.place(x, mesh, sharding.placements(
            (data,) + (None,) * (x.ndim - 1), mesh))

    def place_cache(cache):
        def one(x, pl):
            if placed.is_placed(x):
                return x.redistribute(mesh, pl)
            return sharding.place(x, mesh, pl)
        return pytree.tree_map(one, cache, cache_shardings(cache))

    def prefill_step(params, tokens, image_embeds=None, audio_frames=None,
                     max_len=None):
        with implicit_replication():
            logits, cache = transformer.prefill(
                cfg, params, place_inputs(tokens),
                image_embeds=place_inputs(image_embeds),
                audio_frames=place_inputs(audio_frames), max_len=max_len)
        return logits, place_cache(cache)

    def decode_step(params, cache, token):
        with implicit_replication():
            logits, cache = transformer.decode_step(
                cfg, params, cache, place_inputs(token))
        return logits, place_cache(cache)

    return ServeBundle(prefill_step=prefill_step, decode_step=decode_step,
                       init_params=init_params,
                       param_shardings=param_shardings,
                       cache_shardings=cache_shardings,
                       place_params=place_params)
