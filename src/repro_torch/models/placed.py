"""The model on placed parameters: the local regions of a sharded step.

A sharded train or serve step (``train.steps`` with ``plan=``/``mesh=``)
holds each parameter as a DTensor (``torch.distributed.tensor``) whose
placements come from ``train.sharding``'s specs, the counterpart of the
reference's GSPMD shardings.  Most of the model runs on them unchanged:
DTensor's sharding propagation turns a product with a column-sharded
weight into head-sharded activations, and a row-sharded one into a
partial sum that is all-reduced where it meets the residual stream.  The
few places where propagation cannot carry the model, or where a
hand-written kernel must see plain tensors, run as *local regions*: each
rank computes on its local shards and the result is wrapped back into a
DTensor with the placements the region states.

* :func:`attention_core` runs the attention of each rank's heads (the
  flash kernel or the plain path) where q, k and v are sharded over heads
  (the q heads' split lines up with the kv heads' groups whenever both
  counts divide), and on whole tensors elsewhere.
* :func:`cache_core` fills a KV cache in the same layout, and
  :func:`decode_core` does the same for one decode step over a KV cache
  laid out by ``sharding.cache_specs``, writing the rank's rows in place.
* :func:`embedding` is the vocab-parallel lookup of a row-sharded table.
* :func:`rmsnorm_kernel` runs the RMSNorm kernel on each rank's rows.
* :func:`moe_tokens` runs an MoE layer with its experts split over ranks.
* :func:`whole_last_dim` gathers the logits' vocab.
* :func:`channel_call` runs Mamba and mLSTM on each rank's channels (the
  Mamba state's d_inner, mLSTM's heads), as ``sharding.cache_specs``
  places their states.
* :func:`replicated_call` runs anything else (the sLSTM mixer, whose
  recurrent weights the specs replicate) on whole tensors: every operand
  is gathered, and the result is replicated.

Every function here takes plain tensors too, and then calls its plain
body, so the model's code reads the same on one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

__all__ = ["is_placed", "any_placed", "wrap", "attention_core", "cache_core",
           "decode_core",
           "embedding", "rmsnorm_kernel", "moe_tokens", "whole_last_dim",
           "channel_call", "replicated_call",
           "constrain"]


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_placed(*trees) -> bool:
    return any(is_placed(x) for x in pytree.tree_leaves(trees))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def wrap(local: torch.Tensor, mesh, placements, shape):
    """``local`` as this rank's shard of a DTensor of ``shape``.  A
    partial sum's gradient is the whole gradient on every rank (the sum's
    derivative by each term is one): said explicitly where ``from_local``
    takes ``grad_placements``, and DTensor's own rule otherwise (its
    backward keeps a replicated gradient replicated where the forward
    made a partial sum)."""
    from torch.distributed.tensor import DTensor, Replicate
    kw = {}
    if _FROM_LOCAL_GRADS:
        kw["grad_placements"] = [Replicate() if p.is_partial() else p
                                 for p in placements]
    return DTensor.from_local(local.contiguous(), mesh, placements,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape), **kw)


def _from_local_takes_grads() -> bool:
    import inspect
    from torch.distributed.tensor import DTensor
    return "grad_placements" in inspect.signature(
        DTensor.from_local).parameters


_FROM_LOCAL_GRADS = _from_local_takes_grads()


def _replicate(x, mesh=None):
    """``x`` as a DTensor replicated over every dim of its mesh (``mesh``
    for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_placed(x):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim)


def _mesh_of(*xs):
    for x in xs:
        if is_placed(x):
            return x.device_mesh
    return None


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _head_layout(q, kvs) -> list:
    """Placements for an attention core over (B, S, heads, hd) operands:
    keep q's batch split (dim 0) and head split (dim 2) on each mesh dim
    where every operand divides; replicate everything else."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    out, split = [], {0: 1, 2: 1}
    for i, p in enumerate(q.placements):
        size = mesh.size(i)
        keep = None
        for d in (0, 2):
            if p.is_shard(d):
                n = split[d] * size
                if all(t.shape[d] % n == 0 for t in (q,) + tuple(kvs)):
                    keep = d
        if keep is None:
            out.append(Replicate())
        else:
            split[keep] *= size
            out.append(Shard(keep))
    return out


def attention_core(fn, q, k, v):
    """``fn(q, k, v) -> out`` (q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out
    q's shape) on each rank's batch rows and heads.  Plain tensors go to
    ``fn`` as they are."""
    if not is_placed(q):
        return fn(q, k, v)
    mesh = q.device_mesh
    k, v = (t if is_placed(t) else _replicate(t, mesh) for t in (k, v))
    layout = _head_layout(q, (k, v))
    ql, kl, vl = (t.redistribute(mesh, layout).to_local() for t in (q, k, v))
    return wrap(fn(ql, kl, vl), mesh, layout, q.shape)


def cache_core(fn, k, v, shape) -> dict:
    """``fn(k, v) -> {"k", "v"}``, a KV cache of ``shape`` filled from
    the prompt's keys and values, on each rank's batch rows and heads."""
    if not is_placed(k):
        return fn(k, v)
    mesh = k.device_mesh
    layout = _head_layout(k, (v,))
    cache = fn(*(t.redistribute(mesh, layout).to_local() for t in (k, v)))
    return {n: wrap(cache[n], mesh, layout, shape) for n in ("k", "v")}


def decode_core(fn, q, k_new, v_new, cache):
    """``fn(q, k_new, v_new, k_cache, v_cache, rows) -> out`` for one
    decode step, writing the new key and value into the cache's local
    rows; ``rows`` is the slice of the batch the rank holds.  Returns
    ``(out, cache)``: the cache's DTensors in the core's layout (the same
    buffers where ``cache_specs`` already split it so)."""
    if not is_placed(q):
        out = fn(q, k_new, v_new, cache["k"], cache["v"],
                 slice(0, q.shape[0]))
        return out, cache
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = q.device_mesh
    kc, vc = cache["k"], cache["v"]
    if not is_placed(kc):
        kc, vc = _replicate(kc, mesh), _replicate(vc, mesh)
    layout = _head_layout(q, (k_new, v_new, kc))
    loc = [t.redistribute(mesh, layout) for t in (q, k_new, v_new, kc, vc)]
    (nb, *_), (lo, *_) = compute_local_shape_and_global_offset(
        q.shape, mesh, layout)
    out = fn(*(t.to_local() for t in loc), slice(lo, lo + nb))
    return wrap(out, mesh, layout, q.shape), dict(cache, k=loc[3], v=loc[4])


def constrain(spec_pair, q, k, v):
    """The reference's ``with_sharding_constraint(t, P(ba, None, ha,
    None))`` on q, k and v: each redistributed so that dim 0 is split over
    mesh dim ``ba`` and dim 2 over ``ha``.  On plain tensors it raises as
    the reference does without a mesh in context.  A name the mesh has
    not (the node axis, which a sharded train step splits by rows) leaves
    its dimension as it is."""
    if not is_placed(q):
        raise RuntimeError(
            "attn_shard_constraint requires placed (DTensor) operands, as "
            "the reference's with_sharding_constraint requires a mesh in "
            "context: run the step through a sharded build_train_step / "
            "build_serve_steps (plan=, mesh=)")
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    ba, ha = spec_pair
    pl = [Replicate()] * mesh.ndim
    for d, name in ((0, ba), (2, ha)):
        if name in names:
            pl[names.index(name)] = Shard(d)
    return tuple(t.redistribute(mesh, pl) for t in (q, k, v))


# ---------------------------------------------------------------------------
# Embedding, RMSNorm kernel, MoE experts
# ---------------------------------------------------------------------------

def embedding(tokens, table):
    """``F.embedding(tokens, table)``; a table whose rows are split over
    mesh dims is looked up vocab-parallel: each rank looks up the tokens
    its rows hold, zeros the rest, and the partial rows are summed over
    those dims."""
    if not is_placed(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    t_layout = [p if i in vocab_dims else Replicate()
                for i, p in enumerate(table.placements)]
    table = table.redistribute(mesh, t_layout)
    if not is_placed(tokens):
        tokens = _replicate(tokens, mesh)
    tok_layout = [Replicate() if i in vocab_dims or not p.is_shard(0) else p
                  for i, p in enumerate(tokens.placements)]
    tok = tokens.redistribute(mesh, tok_layout).to_local()
    rows, (lo, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, t_layout)
    local = tok.to(torch.int64) - lo
    miss = (local < 0) | (local >= rows[0])
    # where the tokens' batch is split, a rank's table gradient is its
    # rows' share of the whole one
    grads = [p if i in vocab_dims else
             Partial() if tok_layout[i].is_shard() else Replicate()
             for i, p in enumerate(t_layout)]
    out = F.embedding(torch.where(miss, 0, local),
                      table.to_local(grad_placements=grads))
    out = out * (~miss)[..., None].to(out.dtype)
    layout = [Partial() if i in vocab_dims else p
              for i, p in enumerate(tok_layout)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    return wrap(out, mesh, layout, shape).redistribute(
        mesh, [Replicate() if i in vocab_dims else p
               for i, p in enumerate(tok_layout)])


def rmsnorm_kernel(x, weight):
    """The RMSNorm kernel's wrapper (at its own eps) on each rank's rows of
    ``x`` (the normalized last dim made whole first)."""
    from ..kernels.rmsnorm import ops as rmsnorm_ops
    if not is_placed(x):
        return rmsnorm_ops.rmsnorm(x, weight)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    last = x.ndim - 1
    layout = [p if p.is_shard() and not p.is_shard(last) and
              not p.is_shard(-1) else Replicate() for p in x.placements]
    xl = x.redistribute(mesh, layout).to_local()
    w = weight.full_tensor() if is_placed(weight) else weight
    return wrap(rmsnorm_ops.rmsnorm(xl, w), mesh, layout, x.shape)


def moe_tokens(body, combine, params, xt):
    """An MoE layer over tokens ``xt`` (T, d) with its experts (the
    leaves' dim 0) split over ranks.

    ``body(params, xt, experts) -> (y, aux)`` is the layer's plain code
    on local tensors for the expert slice ``experts``: routing over every
    expert, the FFN of the slice's experts only, and their outputs
    combined, so the ranks of a split return partial sums over disjoint
    experts.  The tokens and the router are made whole first (capacity
    counts every token, as one device counts them), the expert weights
    keep their split over dim 0 and gather any other, and ``combine(params,
    xt) -> y`` (the shared expert, or None) runs on the placed tensors and
    is added to the summed output.  The load-balance aux, which every rank
    computes whole, enters the sum as its share, so that the gradients of
    the tokens and the router, partial sums too, add up right."""
    if not any_placed(params, xt):
        y, aux = body(params, xt, slice(None))
        extra = combine(params, xt)
        return (y if extra is None else y + extra), aux
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = _mesh_of(xt, *pytree.tree_leaves(params))
    experts = {k: params[k] for k in ("w_gate", "w_up", "w_down")}
    e = experts["w_gate"].shape[0]
    split = [i for i in range(mesh.ndim)
             if all(w.placements[i].is_shard(0) for w in experts.values())]
    layout = [Shard(0) if i in split else Replicate()
              for i in range(mesh.ndim)]
    partial = [Partial() if i in split else Replicate()
               for i in range(mesh.ndim)]
    local = {k: w.redistribute(mesh, layout).to_local()
             for k, w in experts.items()}
    (n,), (lo,) = compute_local_shape_and_global_offset((e,), mesh, layout)
    xt_full = _replicate(xt, mesh)
    whole = {"router": _replicate(params["router"], mesh)}
    whole = {k: v.to_local(grad_placements=partial)
             for k, v in dict(whole, xt=xt_full).items()}
    y, aux = body(dict(local, router=whole["router"]), whole["xt"],
                  slice(lo, lo + n))
    share = math.prod(mesh.size(i) for i in split)
    y = wrap(y, mesh, partial, xt.shape)
    aux = wrap(aux / share, mesh, partial, ())
    rep = [Replicate()] * mesh.ndim
    y, aux = y.redistribute(mesh, rep), aux.redistribute(mesh, rep)
    extra = combine(params, xt_full)
    return (y if extra is None else y + extra), aux


def whole_last_dim(x):
    """``x`` with its last dimension whole on every rank (the logits'
    vocab, split by a row-sharded tied embedding or a column-sharded
    head), for the loss's gather and the sampler."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() or p.is_shard(last) or p.is_shard(-1)
        else p for p in x.placements])


# ---------------------------------------------------------------------------
# Mamba and mLSTM on each rank's channels
# ---------------------------------------------------------------------------

# Per mixer: the weight whose dim 0 holds the channels (its spec splits it
# over the model axis), and the dim of each weight and state leaf that
# holds them.  "halves" is a weight whose columns are two halves of
# channels (mLSTM's input and forget gates): the rank takes its part of
# each.  The up-projections' columns are two halves too, but their spec
# splits them in place (one rank may hold all of one half): the rank keeps
# its block of columns and the product is regrouped (``_Channels.halves``).
_CHANNELS = {
    "mamba": {"out": "out_proj",
              "weights": {"in_proj": 1, "conv_w": 1, "conv_b": 0,
                          "x_proj": 0, "dt_proj": 1, "dt_bias": 0,
                          "a_log": 0, "d_skip": 0, "out_proj": 0},
              "state": {"h": 1, "conv": 2}},
    "mlstm": {"out": "down_proj",
              "weights": {"up_proj": 1, "conv_w": 1, "conv_b": 0, "wq": 1,
                          "wk": 1, "wv": 1, "w_if": "halves", "b_i": 0,
                          "b_f": 0, "skip_w": 0, "norm_w": 0,
                          "down_proj": 0},
              "state": {"c": 1, "n": 1, "m": 1, "conv": 2}},
}


class _Channels:
    """The cross-channel steps of a mixer on the rank's channels (the
    counterpart of ``ssm.Whole``), over the mesh dims ``split``; ``act`` is
    the layout of batch-leading activations (batch rows split where the
    input's are, replicated elsewhere), ``batch`` their global batch size,
    and ``lo``/``c`` the rank's channels of ``n``.  Each step is a DTensor
    redistribution, so that autograd carries its gradient: a gather's is a
    reduce-scatter, a sum's an all-reduce."""

    def __init__(self, mesh, split, act, batch: int, lo: int, c: int,
                 n: int):
        self.mesh, self.split, self.act = mesh, split, act
        self.batch, self.lo, self.c = batch, lo, c
        self.k = n // c

    def layout(self, on_split) -> list:
        return [on_split if i in self.split else p
                for i, p in enumerate(self.act)]

    def _shape(self, t, dim=None) -> tuple:
        shape = [self.batch] + list(t.shape[1:])
        if dim is not None:
            shape[dim] *= self.k
        return tuple(shape)

    def _whole(self, t, placements, shape):
        from torch.distributed.tensor import Partial
        return wrap(t, self.mesh, placements, shape).redistribute(
            self.mesh, self.act).to_local(
            grad_placements=self.layout(Partial()))

    def gather(self, t):
        """``t`` (the rank's channels in its last dim) with every
        channel."""
        if not self.split:
            return t
        from torch.distributed.tensor import Shard
        last = t.ndim - 1
        return self._whole(t, self.layout(Shard(last)), self._shape(t, last))

    def halves(self, t):
        """The rank's channels of each half of a product whose last dim
        holds the rank's block of the two halves' columns."""
        full = self.gather(t)
        half = full.shape[-1] // 2
        lo, hi = self.lo, self.lo + self.c
        return full[..., lo:hi], full[..., half + lo:half + hi]

    def psum(self, t):
        """The sum of the ranks' partial products ``t``."""
        if not self.split:
            return t
        from torch.distributed.tensor import Partial
        return self._whole(t, self.layout(Partial()), self._shape(t))

    def rms_norm(self, h, weight, eps: float = 1e-6):
        """``common.rms_norm`` over every channel of the rank's ``h``."""
        x = h.to(torch.float32)
        var = self.psum(torch.sum(x * x, dim=-1, keepdim=True)) / (
            h.shape[-1] * self.k)
        out = x * torch.rsqrt(var + eps) * (1.0 + weight.to(torch.float32))
        return out.to(h.dtype)


def channel_call(fn, kind: str, params, spec, x, state=None,
                 unit: int = 1):
    """``fn(params, spec, x[, state], ch=...)`` (a Mamba or mLSTM entry of
    ``models.ssm``, ``kind`` naming which) on each rank's channels, where
    the mixer's weights are placed.  The channels are split over the mesh
    dims that split the out-projection's rows (the model axis), when their
    ``unit``s (mLSTM's heads) divide evenly, and the batch rows stay split
    where ``x``'s are.  Each weight is redistributed to the rank's
    channels, the input and the state likewise (the state is laid out as
    ``sharding.cache_specs`` lays it where the model axis divides it);
    ``fn`` runs on local tensors with a :class:`_Channels` for its
    cross-channel steps, and returns the out-projection's partial sum, a
    DTensor, with the new state on the rank's channels."""
    if not any_placed(params, x, state):
        return fn(params, spec, x) if state is None else \
            fn(params, spec, x, state)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    table = _CHANNELS[kind]
    mesh = _mesh_of(x, *pytree.tree_leaves(params))
    params = {k: w if is_placed(w) else _replicate(w, mesh)
              for k, w in params.items()}
    x = x if is_placed(x) else _replicate(x, mesh)
    out_w = params[table["out"]]
    n = out_w.shape[0]
    split = [i for i in range(mesh.ndim) if out_w.placements[i].is_shard(0)
             and not x.placements[i].is_shard()]
    if (n // unit) % math.prod(mesh.size(i) for i in split):
        split = []
    act = [Shard(0) if i not in split and p.is_shard(0) else Replicate()
           for i, p in enumerate(x.placements)]
    batch = [i for i, p in enumerate(act) if p.is_shard()]
    (c,), (lo,) = compute_local_shape_and_global_offset(
        (n,), mesh, [Shard(0) if i in split else Replicate()
                     for i in range(mesh.ndim)])
    ch = _Channels(mesh, split, act, x.shape[0], lo, c, n)

    def weight(name, w):
        dim = table["weights"][name]
        grads = [Partial() if i in batch else Replicate()
                 for i in range(mesh.ndim)]
        if dim == "halves":
            full = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
                grad_placements=[Partial() if i in split else g
                                 for i, g in enumerate(grads)])
            half = full.shape[-1] // 2
            per = full.shape[-1] // 2 // ch.k
            at = lo // (n // half)
            return torch.cat([full[..., at:at + per],
                              full[..., half + at:half + at + per]], dim=-1)
        pl = [Shard(dim) if i in split else Replicate()
              for i in range(mesh.ndim)]
        return w.redistribute(mesh, pl).to_local(
            grad_placements=[Shard(dim) if i in split else g
                             for i, g in enumerate(grads)])

    local = {k: weight(k, w) for k, w in params.items()}
    xl = x.redistribute(mesh, act).to_local(
        grad_placements=ch.layout(Partial()))
    if state is None:
        out, new_state = fn(local, spec, xl, ch=ch), None
    else:
        st = {k: (v if is_placed(v) else _replicate(v, mesh)).redistribute(
            mesh, ch.layout(Shard(table["state"][k]))).to_local()
            for k, v in state.items()}
        out, new_state = fn(local, spec, xl, st, ch=ch)
    if isinstance(out, tuple):
        out, new_state = out
    out = wrap(out, mesh, ch.layout(Partial()), tuple(x.shape[:-1])
               + (out.shape[-1],))
    if new_state is None:
        return out
    return out, {k: wrap(v, mesh, ch.layout(Shard(table["state"][k])),
                         ch._shape(v, table["state"][k]))
                 for k, v in new_state.items()}


def replicated_call(fn, *args):
    """``fn(*args)`` on whole tensors: every DTensor among ``args``'
    leaves is gathered and ``fn`` runs on the local copies; every tensor
    it returns is wrapped back, replicated."""
    leaves = pytree.tree_leaves(args)
    mesh = _mesh_of(*leaves)
    if mesh is None:
        return fn(*args)
    local = pytree.tree_map(
        lambda x: _replicate(x).to_local() if is_placed(x) else x, args)
    from torch.distributed.tensor import Replicate
    out = fn(*local)
    return pytree.tree_map(
        lambda x: wrap(x, mesh, [Replicate()] * mesh.ndim, x.shape)
        if isinstance(x, torch.Tensor) else x, out)
