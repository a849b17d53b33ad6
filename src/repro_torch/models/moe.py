"""Mixture-of-Experts with top-k routing and capacity-factor dispatch.

The port of ``repro.models.moe``, with the same scatter-based dispatch:

  1. router logits -> top-k experts + gates per token
  2. position-in-expert via a (T, E) cumsum (small)
  3. scatter tokens into the (E, C, d) expert buffer (capacity-dropped)
  4. batched expert FFN: (E, C, d) x (E, d, ff) products
  5. gather outputs back and combine with gates

A switch-style load-balance auxiliary loss is returned alongside the
output.  Every kept token has its own (expert, slot), and only the drop
row (row ``capacity``, sliced away) takes more than one write, so the
scatter is a plain out-of-place ``index_put``: it equals the reference's
``.at[].add``, is deterministic on the card, and runs under
``torch.func.vmap`` (the trainer's per-node gradients), where the in-place
form does not.  Ties between router probabilities go to the lower expert
index, as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import common, placed

__all__ = ["MoESpec", "init_moe", "moe_forward", "route", "capacity"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int = 1
    capacity_factor: float = 1.25
    shared_expert: bool = False   # llama4-style always-on shared expert
    router_noise: float = 0.0
    # >1: partition the batch's tokens into this many groups and dispatch
    # each group alone with its own capacity; the aux is their mean
    dispatch_groups: int = 1


def init_moe(gen: torch.Generator, spec: MoESpec, dtype=torch.float32):
    e, d, f = spec.num_experts, spec.d_model, spec.d_ff
    p = {
        "router": common.dense_init(gen, (d, e), dtype, scale=0.02),
        "w_gate": common.dense_init(gen, (e, d, f), dtype),
        "w_up": common.dense_init(gen, (e, d, f), dtype),
        "w_down": common.dense_init(gen, (e, f, d), dtype),
    }
    if spec.shared_expert:
        p["shared_gate"] = common.dense_init(gen, (d, f), dtype)
        p["shared_up"] = common.dense_init(gen, (d, f), dtype)
        p["shared_down"] = common.dense_init(gen, (f, d), dtype)
    return p


def moe_forward(params, spec: MoESpec, x):
    """x: (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    g = spec.dispatch_groups
    if g > 1 and b % g == 0:
        xg = x.reshape(g, (b // g) * s, d)
        outs = [_moe_tokens(params, spec, xg[i]) for i in range(g)]
        y = torch.stack([o[0] for o in outs]).reshape(b, s, d)
        return y, torch.mean(torch.stack([o[1] for o in outs]))
    y, aux = _moe_tokens(params, spec, x.reshape(b * s, d))
    return y.reshape(b, s, d), aux


def capacity(spec: MoESpec, t: int) -> int:
    """Slots an expert has for ``t`` tokens, in Python floats as the
    reference computes it."""
    return max(int(t * spec.top_k / spec.num_experts * spec.capacity_factor),
               1)


def route(params, spec: MoESpec, xt):
    """Routing of ``xt`` (T, d): (probs (T, E) float32, gates (T, k)
    float32 renormalised, experts (T, k), slots (T, k), keep (T, k)).

    Choices are processed in order, so top-1 assignments win capacity over
    top-2; a dropped choice has slot ``capacity`` (the drop row)."""
    t = xt.shape[0]
    e, k = spec.num_experts, spec.top_k
    cap = capacity(spec, t)
    # logits in the activation dtype, then float32, as the reference does
    logits = (xt @ params["router"]).to(torch.float32)          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities: jax.lax.top_k's order
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    experts = torch.arange(e, device=xt.device)
    prev_counts = torch.zeros((e,), dtype=torch.int64, device=xt.device)
    slots, keeps = [], []
    for choice in range(k):
        idx = expert_idx[:, choice]
        onehot = (idx[:, None] == experts).to(torch.int64)      # (T, E)
        pos_in_e = torch.cumsum(onehot, dim=0) - onehot
        pos = torch.gather(pos_in_e, 1, idx[:, None])[:, 0]
        pos = pos + prev_counts[idx]
        prev_counts = prev_counts + onehot.sum(dim=0)
        keep = pos < cap
        slots.append(torch.where(keep, pos, cap))
        keeps.append(keep)
    return (probs, gate_vals, expert_idx, torch.stack(slots, dim=1),
            torch.stack(keeps, dim=1))


def _moe_tokens(params, spec: MoESpec, xt):
    """xt: (T, d) -> (y (T, d), aux).  On placed parameters the experts
    split over ranks compute their own tokens (``placed.moe_tokens``)."""
    return placed.moe_tokens(
        lambda p, x, mine: _routed(p, spec, x, mine),
        lambda p, x: _shared(p, spec, x), params, xt)


def _shared(params, spec: MoESpec, xt):
    """The always-on shared expert's output, or None."""
    if not spec.shared_expert:
        return None
    return (F.silu(xt @ params["shared_gate"])
            * (xt @ params["shared_up"])) @ params["shared_down"]


def _routed(params, spec: MoESpec, xt, mine: slice):
    """The routed experts' output and the aux over ``xt`` (T, d), of the
    experts in the slice ``mine`` of the expert axis (whose weights
    ``params`` holds): routing over every expert, the FFN and the combine
    over the slice's."""
    t, d = xt.shape
    e, k = spec.num_experts, spec.top_k
    cap = capacity(spec, t)
    probs, gate_vals, expert_idx, slots, keeps = route(params, spec, xt)

    # switch-style load balance: E * sum_e fraction_e * mean_prob_e
    top1 = expert_idx[:, 0]
    experts = torch.arange(e, device=xt.device)
    frac = torch.mean((top1[:, None] == experts).to(torch.float32), dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))

    buf = torch.zeros((e, cap, d), dtype=xt.dtype, device=xt.device)
    for choice in range(k):
        # out of place: under vmap the in-place form cannot write batched
        # values into an unbatched buffer
        padded = torch.zeros((e, cap + 1, d), dtype=xt.dtype,
                             device=xt.device).index_put(
            (expert_idx[:, choice], slots[:, choice]),
            xt * keeps[:, choice, None].to(xt.dtype))
        buf = buf + padded[:, :cap]

    # expert FFN (SwiGLU), batched over experts
    lo, n = mine.start or 0, params["w_gate"].shape[0]
    if n < e:
        buf = buf[lo:lo + n]
    h = torch.matmul(buf, params["w_gate"])
    u = torch.matmul(buf, params["w_up"])
    out = torch.matmul(F.silu(h) * u, params["w_down"]).to(xt.dtype)

    # combine: gather each token's expert output, weight by its gate, cast
    # to the activation dtype first; a dropped token reads row cap-1 with
    # gate 0, so its gradient adds only zeros there
    y = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    for choice in range(k):
        gate = torch.where(keeps[:, choice], gate_vals[:, choice],
                           0.0).to(xt.dtype)
        safe_slot = torch.clamp(slots[:, choice], max=cap - 1)
        idx = expert_idx[:, choice]
        if n < e:
            # another rank's expert adds nothing here
            idx = idx - lo
            gate = torch.where((idx >= 0) & (idx < n), gate, 0.0)
            idx = torch.clamp(idx, 0, n - 1)
        y = y + out[idx, safe_slot] * gate[:, None]
    return y, aux
