"""The unified decentralized-algorithm protocol: the main-path subset of
``repro.core.algorithm``.

Every method is expressed as the same transitions over an algorithm-private
state with stacked node parameters (leading axis m):

    init()                        -> state        (all nodes at x0)
    step(state, batch, phi, a)    -> state        (one inner iteration)
    outer(state)                  -> state        (snapshot / full-grad refresh)
    end_outer(state, K)           -> state        (close an inner round, e.g.
                                                   Algorithm 1's tail average)

plus declarative :class:`AlgoMeta`.  The single driver in
:mod:`repro_torch.core.runner` consumes this protocol.  The whole registry
of the reference is ported: DPSVRG (paper Algorithm 1), DSPG [paper ref.
11], DPG [ref. 10], GT-SVRG [refs 18/19], the beyond-paper loopless DPSVRG
and DVR.  All but GT-SVRG have a fused twin, whose inner update runs
through the fused resident-step kernel (``kernels.fused_update``).  Steps
that thread a mix state (``cstate``) ride the stateful ``compressed``
transport through ``compression.mix_with_state``.

PyTorch runs eagerly, so the reference's step memoization
(``_shared_step``), which existed to keep XLA executables warm across
rebuilt algorithms, has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import compression, gossip, prox as prox_lib, schedules, spmd, \
    svrg, transport
from ..kernels.fused_update import ops as fused_ops

__all__ = [
    "Problem",
    "UpdateRule",
    "UPDATE_RULES",
    "prox_gossip_update",
    "AlgoMeta",
    "Algorithm",
    "ParamState",
    "DPSVRGState",
    "GTSVRGState",
    "LooplessState",
    "DPSVRGHyperParams",
    "DSPGHyperParams",
    "build_node_grad_fn",
    "build_node_full_grad_fn",
    "build_dpsvrg_inner_step",
    "build_dspg_step",
    "build_gt_svrg_inner_step",
    "build_dvr_inner_step",
    "build_fused_svrg_inner",
    "build_fused_sgd_step",
    "dpsvrg_algorithm",
    "dspg_algorithm",
    "dpg_algorithm",
    "gt_svrg_algorithm",
    "loopless_dpsvrg_algorithm",
    "dvr_algorithm",
    "ALGORITHMS",
]


class Problem(NamedTuple):
    """A decentralized composite problem min F = (1/m) sum_i f_i + h.

    loss_fn:      ``loss_fn(params, batch) -> scalar`` per-node smooth loss,
                  written in torch (``torch.func`` differentiates it)
    prox:         the non-smooth regularizer's proximal operator
    x0:           stacked start point, tensor leaves (m, ...)
    full_data:    per-node datasets, tensor leaves (m, n, ...)
    objective_fn: optional override for the recorded objective F(x_bar)

    All tensors lie on the device the run executes on.
    """
    loss_fn: Callable
    prox: prox_lib.Prox
    x0: Any
    full_data: Any
    objective_fn: Callable | None = None


@dataclasses.dataclass(frozen=True)
class DPSVRGHyperParams:
    alpha: float = 0.01          # constant step size (the VR payoff)
    beta: float = 1.07           # inner-loop growth base
    n0: int = 8                  # initial inner-loop length
    num_outer: int = 30          # S
    batch_size: int = 1          # paper uses single-sample inner steps
    k_max: int | None = None     # multi-consensus cap (None = faithful, k rounds at step k)
    single_consensus: bool = False  # Fig.3 ablation: one gossip round per step
    compress_bits: int | None = None  # int-quantized gossip w/ error feedback


@dataclasses.dataclass(frozen=True)
class DSPGHyperParams:
    alpha0: float = 0.01
    decay: float = 0.5           # alpha_k = alpha0 / (k+1)^decay
    batch_size: int = 1
    constant_step: bool = False  # with a constant step DSPG stalls (inexact convergence)


# ---------------------------------------------------------------------------
# Update rules: the loss-agnostic inner update
# ---------------------------------------------------------------------------

class UpdateRule(NamedTuple):
    """Gradient-direction rule of the shared prox-gossip update:
    ``direction(g_now, g_snap, mu) -> v``."""
    name: str
    needs_snapshot: bool
    direction: Callable


def _svrg_direction(g_now, g_snap, mu):
    return pytree.tree_map(lambda a, b, c: a - b + c, g_now, g_snap, mu)


def _sgd_direction(g_now, g_snap, mu):
    return g_now


DPSVRG_RULE = UpdateRule("dpsvrg", True, _svrg_direction)
DSPG_RULE = UpdateRule("dspg", False, _sgd_direction)

UPDATE_RULES: dict[str, UpdateRule] = {
    "dpsvrg": DPSVRG_RULE,
    "dspg": DSPG_RULE,
}


def prox_gossip_update(params, v, phi, alpha, prox: prox_lib.Prox,
                       mix_fn: Callable = gossip.mix_stacked):
    """Algorithm 1 lines 8-11 for all nodes at once:

        q     = x - alpha * v
        q_hat = gossip(phi, q)
        x'    = prox_h^alpha(q_hat)
    """
    q = pytree.tree_map(lambda x, vi: x - alpha * vi.to(x.dtype), params, v)
    return prox.apply(mix_fn(phi, q), alpha)


# ---------------------------------------------------------------------------
# Gradient functions (stacked over nodes with torch.func.vmap)
# ---------------------------------------------------------------------------

def build_node_grad_fn(loss_fn: Callable) -> Callable:
    """loss_fn(params, batch)->scalar  =>  grad over stacked params.

    Stacked signature: params leaves (m, ...), batch leaves (m, B, ...).
    vmap over the node axis keeps each node's gradient private.
    """
    return torch.func.vmap(torch.func.grad(loss_fn))


def build_node_full_grad_fn(loss_fn: Callable, full_batch) -> Callable:
    """Full local gradient closure over each node's entire dataset."""
    g = build_node_grad_fn(loss_fn)

    def full_grad(params):
        return g(params, full_batch)

    return full_grad


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def build_dpsvrg_inner_step(loss_fn: Callable, prox: prox_lib.Prox,
                            compress_bits: int | None = None):
    """``step(params, svrg_state, batch, phi, alpha, cstate) -> (params,
    cstate)``: Algorithm 1 lines 7-11 for all nodes at once.  ``phi`` may be
    any wire format (dense, ``BandedPhi``, ``CompressedPhi``).  ``cstate``
    is the error-feedback state of compressed gossip (None, returned
    untouched, for stateless transports).  ``compress_bits`` wraps the
    incoming phi in a ``CompressedPhi``, so hp-level quantization and the
    ``compressed`` transport share one path."""
    node_grad = build_node_grad_fn(loss_fn)

    def step(params, svrg_state, batch, phi, alpha, cstate):
        if compress_bits is not None and \
                not isinstance(phi, compression.CompressedPhi):
            phi = compression.CompressedPhi(phi, compress_bits)
        v = svrg.corrected_gradient(node_grad, params, svrg_state, batch)
        q = pytree.tree_map(lambda x, vi: x - alpha * vi.to(x.dtype), params,
                            v)
        q_hat, cstate = compression.mix_with_state(phi, q, cstate)
        return prox.apply(q_hat, alpha), cstate

    return step


def build_dspg_step(loss_fn: Callable, prox: prox_lib.Prox):
    """DSPG [paper ref. 11]: plain stochastic gradient + single gossip + prox,
    decaying step size."""
    node_grad = build_node_grad_fn(loss_fn)

    def step(params, batch, w, alpha):
        return prox_gossip_update(params, node_grad(params, batch), w, alpha,
                                  prox)

    return step


def build_gt_svrg_inner_step(loss_fn: Callable, prox: prox_lib.Prox):
    """GT-SVRG inner update: prox-gossip step + gradient-tracking recursion.

    Both mixes (the iterate and the tracker) go through
    ``compression.mix_with_state``: ``cstate`` is a pair of error-feedback
    states, one per transmitted quantity, or None for stateless
    transports."""
    node_grad = build_node_grad_fn(loss_fn)

    def inner(params, tracker, v_prev, est, batch, w, a, cstate):
        cq, ct = cstate if cstate is not None else (None, None)
        q = pytree.tree_map(lambda x, y: x - a * y, params, tracker)
        q_hat, cq = compression.mix_with_state(w, q, cq)
        new_params = prox.apply(q_hat, a)
        v_new = svrg.corrected_gradient(node_grad, new_params, est, batch)
        t_mixed, ct = compression.mix_with_state(w, tracker, ct)
        new_tracker = pytree.tree_map(lambda ty, vn, vp: ty + vn - vp,
                                      t_mixed, v_new, v_prev)
        new_cstate = None if cq is None and ct is None else (cq, ct)
        return new_params, new_tracker, v_new, new_cstate

    return inner


def build_dvr_inner_step(loss_fn: Callable, prox: prox_lib.Prox, rho: float):
    """Dual-Free DVR inner update (Hendrikx et al., arXiv 2006.14384), as the
    reference adapts it to the runner's sampled-batch interface:

        v  = SVRG-corrected gradient
        y  = x - alpha v                      (local computation step)
        x' = prox_h((1-rho) y + rho W y)      (damped gossip)

    The mix goes through ``compression.mix_with_state``, so DVR rides the
    stateful ``compressed`` transport too."""
    node_grad = build_node_grad_fn(loss_fn)

    def step(params, est, batch, phi, alpha, cstate):
        v = svrg.corrected_gradient(node_grad, params, est, batch)
        y = pytree.tree_map(lambda x, vi: x - alpha * vi.to(x.dtype), params,
                            v)
        y_mixed, cstate = compression.mix_with_state(phi, y, cstate)
        q = pytree.tree_map(lambda a, b: (1.0 - rho) * a + rho * b, y,
                            y_mixed)
        return prox.apply(q, alpha), cstate

    return step


# ---------------------------------------------------------------------------
# Fused resident-step twins (kernels.fused_update)
# ---------------------------------------------------------------------------
#
# ``runner.run(ExecSpec(resident=True, kernel="fused"|"auto"))`` swaps these
# in for the unfused steps.  They compute the SAME update — prox(W @ (x -
# alpha*v)) — through one launch of the fused kernel over the stacked (m, d)
# buffer, and keep the unfused step whenever the configuration has no fused
# lowering:
#
# * the phi wire format has no dense matrix (``transport.mix_matrix``
#   returns None: compressed gossip); a ``BandedPhi`` lowers to its dense
#   matrix on the device,
# * a stateful transport threads a mix state (cstate is not None),
# * the prox has no ``fused_spec`` (only l1 / sql2 / none lower),
# * kernel="auto" at per-node sizes where the unfused step wins
#   (``fused_ops.fused_wins``).
#
# On node-sharded state the wire lies between q and the prox, so no single
# launch covers the step: q on the rank's rows (``svrg_step`` for the svrg
# rule), the wire, then each row's mix and l1 prox through ``mix_prox``
# where the offsets are {0, +1, -1} (``_sharded_kernel_step``,
# ``_sharded_sgd_step``).

def _fused_fallback(mode: str, prox: prox_lib.Prox, phi, cstate, params):
    """-> (dense W or None, fused spec or None); (None, None) = use the
    unfused step."""
    spec = prox.fused_spec
    if spec is None or cstate is not None:
        return None, None
    if mode == "auto" and not fused_ops.fused_wins(
            fused_ops.tree_node_dim(params)):
        return None, None
    w = transport.mix_matrix(phi)
    if w is None:
        return None, None
    return gossip.as_mix_tensor(w, pytree.tree_leaves(params)[0]), spec


def _kernel_route(mode: str, cstate, params) -> bool:
    """Whether a node-sharded step takes the elementwise kernels:
    stateless gossip, and for "auto" the per-node sizes where they win.
    ``kernel="fused"`` where they cannot run raises."""
    if cstate is not None:
        if mode == "fused":
            raise ValueError(
                "kernel='fused' on a node-sharded run: the svrg_step / "
                "mix_prox route needs stateless gossip, and this transport "
                "threads a mix state; use kernel='auto' or 'plain'")
        return False
    return mode == "fused" or fused_ops.fused_wins(
        fused_ops.tree_node_dim(params))


def _three_band_weights(phi, rows: slice, like: torch.Tensor):
    """(w_self, w_up, w_down), each a float32 (rows,) tensor on ``like``'s
    device, of this rank's ``rows`` when ``phi`` (a ``PermutePhi`` or a
    ``GatheredPhi`` over a ``BandedPhi``) has only the offsets {0, +1,
    -1}, else None.  Read from the step's coefficients where they lie (the
    staged tensors of a resident run): nothing is copied to the host."""
    banded = phi.inner if isinstance(phi, gossip.GatheredPhi) else phi
    if not isinstance(banded, (gossip.BandedPhi, gossip.PermutePhi)):
        return None
    m = banded.coeffs.shape[-1]
    if m < 3 or not set(d % m for d in banded.offsets) <= {0, 1, m - 1}:
        return None
    coeffs = gossip.as_mix_tensor(banded.coeffs, like)[:, rows]
    w = {0: None, 1: None, m - 1: None}
    for b, d in enumerate(banded.offsets):
        w[d % m] = coeffs[b] if w[d % m] is None else w[d % m] + coeffs[b]
    return tuple(torch.zeros_like(coeffs[0]) if w[k] is None else w[k]
                 for k in (0, 1, m - 1))


def _mix_prox_plan(prox: prox_lib.Prox, phi, params, alpha,
                   rho: float | None):
    """((w_self, w_up, w_down) over this rank's rows, threshold) of the
    ``mix_prox`` route of a node-sharded step (DVR's damping folded into
    the weights), or None where it has none: a prox other than l1, or
    offsets beyond {0, +1, -1}."""
    spec = prox.fused_spec
    if spec is None or spec[0] != "l1":
        return None
    ax = gossip.phi_node_axis(phi)
    w = _three_band_weights(phi, ax.rows, pytree.tree_leaves(params)[0])
    if w is None:
        return None
    if rho is not None:
        ws, wu, wd = w
        w = ((1.0 - rho) + rho * ws, rho * wu, rho * wd)
    return w, prox_lib.f32_product(alpha, spec[1])


def _mix_prox_rows(phi, q: torch.Tensor, aux, weights, thresh):
    """The wire, then each row's mix and l1 prox through ``ops.mix_prox``:
    ``q`` is this rank's (rows, d) buffer; its neighbours' rows come by
    one point-to-point exchange a band (``PermutePhi``) or an all-gather
    (``GatheredPhi``)."""
    ax = gossip.phi_node_axis(phi)
    if isinstance(phi, gossip.PermutePhi):
        received = gossip.permute_exchange(phi, [q])[0]
        by_offset = dict(zip((d % ax.m for d in phi.offsets), received))
        up, down = by_offset.get(1, q), by_offset.get(ax.m - 1, q)
    else:
        full = spmd.all_gather_rows(q, ax)
        idx = torch.arange(ax.rows.start, ax.rows.stop, device=q.device)
        up, down = full[(idx + 1) % ax.m], full[(idx - 1) % ax.m]
    ws, wu, wd = weights
    out = [fused_ops.mix_prox(q[r].contiguous(), up[r].contiguous(),
                              down[r].contiguous(), ws[r], wu[r], wd[r],
                              thresh)
           for r in range(q.shape[0])]
    return fused_ops.unflatten_stacked(torch.stack(out), aux)


def _sharded_kernel_step(prox: prox_lib.Prox, phi, params, v_parts, alpha,
                         rho: float | None):
    """One node-sharded svrg step through the elementwise kernels: ``q = x
    - alpha (g_now - g_snap + mu)`` over the rank's rows through
    ``ops.svrg_step``, then the wire; on offsets {0, +1, -1} with an l1
    prox the mix and the prox of each row through ``ops.mix_prox``, else
    the plain mix and prox."""
    rows = pytree.tree_leaves(params)[0].shape[0]
    x_buf, aux = fused_ops.flatten_stacked(params, rows)
    g_now, g_snap, mu = (fused_ops.flatten_stacked(t, rows)[0]
                         for t in v_parts)
    q = fused_ops.svrg_step(x_buf, g_now, g_snap, mu, alpha)
    plan = _mix_prox_plan(prox, phi, params, alpha, rho)
    if plan is not None:
        return _mix_prox_rows(phi, q, aux, *plan)
    q_tree = fused_ops.unflatten_stacked(q, aux)
    mixed = gossip.mix_stacked(phi, q_tree)
    if rho is not None:
        mixed = pytree.tree_map(lambda a, b: (1.0 - rho) * a + rho * b,
                                q_tree, mixed)
    return prox.apply(mixed, alpha)


def _sharded_sgd_step(mode: str, prox: prox_lib.Prox, phi, params, grad,
                      alpha):
    """A node-sharded step of the sgd rule (DSPG, DPG) through the kernels,
    or None for the plain step: ``q = x - alpha g`` on the rank's rows (the
    plain step's arithmetic), the wire, then each row's mix and l1 prox
    through ``ops.mix_prox``.  Where that route does not exist (another
    prox, wider offsets) ``kernel="fused"`` raises; ``grad()`` gives the
    rank's gradient."""
    plan = (_mix_prox_plan(prox, phi, params, alpha, None)
            if _kernel_route(mode, None, params) else None)
    if plan is None:
        if mode == "fused":
            raise ValueError(
                "kernel='fused' on a node-sharded run of the sgd rule: its "
                "kernel route is mix_prox after the wire, which needs an "
                "l1 prox and the offsets {0, +1, -1}; use kernel='auto' or "
                "'plain' here")
        return None
    rows = pytree.tree_leaves(params)[0].shape[0]
    x_buf, aux = fused_ops.flatten_stacked(params, rows)
    g_buf = fused_ops.flatten_stacked(grad(), rows)[0]
    return _mix_prox_rows(phi, x_buf - alpha * g_buf, aux, *plan)


def build_fused_svrg_inner(loss_fn: Callable, prox: prox_lib.Prox,
                           mode: str, rho: float | None = None):
    """Fused twin of ``build_dpsvrg_inner_step`` (rho=None) /
    ``build_dvr_inner_step`` (rho set: W_eff = (1-rho) I + rho W folds DVR's
    damped gossip into the kernel's mix matrix).  Same signature:
    ``inner(params, est, batch, phi, alpha, cstate) -> (params, cstate)``."""
    base = (build_dvr_inner_step(loss_fn, prox, rho) if rho is not None
            else build_dpsvrg_inner_step(loss_fn, prox))
    node_grad = build_node_grad_fn(loss_fn)

    def inner(params, est, batch, phi, alpha, cstate):
        if gossip.phi_node_axis(phi) is not None:
            if not _kernel_route(mode, cstate, params):
                return base(params, est, batch, phi, alpha, cstate)
            parts = (node_grad(params, batch), node_grad(est.snapshot, batch),
                     est.full_grad)
            return _sharded_kernel_step(prox, phi, params, parts, alpha,
                                        rho), cstate
        w, spec = _fused_fallback(mode, prox, phi, cstate, params)
        if w is None:
            return base(params, est, batch, phi, alpha, cstate)
        if rho is not None:
            w = (1.0 - rho) * torch.eye(w.shape[0], dtype=w.dtype,
                                        device=w.device) + rho * w
        kind, lam = spec
        g_now = node_grad(params, batch)
        g_snap = node_grad(est.snapshot, batch)
        x = fused_ops.fused_resident_step(
            w, params, (g_now, g_snap, est.full_grad), alpha, lam,
            rule="svrg", prox_kind=kind)
        return x, cstate

    return inner


def build_fused_sgd_step(loss_fn: Callable, prox: prox_lib.Prox, mode: str):
    """Fused twin of ``build_dspg_step``: one kernel launch for
    prox(W @ (x - alpha*g)); on node-sharded state ``mix_prox`` after the
    wire (``_sharded_sgd_step``)."""
    base = build_dspg_step(loss_fn, prox)
    node_grad = build_node_grad_fn(loss_fn)

    def step_fn(params, batch, phi, alpha):
        if gossip.phi_node_axis(phi) is not None:
            out = _sharded_sgd_step(mode, prox, phi, params,
                                    lambda: node_grad(params, batch), alpha)
            return base(params, batch, phi, alpha) if out is None else out
        w, spec = _fused_fallback(mode, prox, phi, None, params)
        if w is None:
            return base(params, batch, phi, alpha)
        kind, lam = spec
        return fused_ops.fused_resident_step(
            w, params, (node_grad(params, batch),), alpha, lam, rule="sgd",
            prox_kind=kind)

    return step_fn


# ---------------------------------------------------------------------------
# Protocol: declarative metadata + the state/step/outer triple
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlgoMeta:
    """Everything the generic runner needs to know about a method (the
    reference's ``AlgoMeta``; see its docstring for each field).

    Loop structure — exactly one of ``outer_lengths`` (inner-round lengths;
    ``outer()`` before each round, ``end_outer()`` after) or ``num_steps``.
    Cost accounting — ``step_grad_factor``, ``outer_full_grad``,
    ``init_full_grad``.  Gossip — ``gossip_rounds(k)``, ``gossip_payloads``,
    ``slot_start``.  Recording — ``stepsize``, ``snapshot_prob``,
    ``track_consensus``, ``comm_metric``, ``epoch_metric``, ``record_key``,
    ``final_record``.  ``resident_objective``: optional
    ``objective(stacked_params, full_data) -> 0-d tensor`` for the resident
    path's on-device record.  ``fused_step(mode) -> step``: the fused twin
    of ``step`` for ``kernel="fused"|"auto"``, or None.
    """
    name: str
    stepsize: Callable[[int], float]
    outer_lengths: tuple[int, ...] | None = None
    num_steps: int | None = None
    batch_size: int = 1
    step_grad_factor: int = 1
    outer_full_grad: bool = False
    init_full_grad: bool = False
    gossip_rounds: Callable[[int], int] = lambda k: 1
    gossip_payloads: int = 1
    slot_start: int = 0
    snapshot_prob: float | None = None
    track_consensus: bool = False
    comm_metric: str = "steps"
    epoch_metric: str = "grad"
    record_key: str = "round"
    final_record: bool = True
    compress_bits: int | None = None
    resident_objective: Callable | None = None
    fused_step: Callable[[str], Callable] | None = None


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """A decentralized algorithm bound to a :class:`Problem`.

    ``init_mix_state(state, make=...)`` opts the algorithm into stateful
    gossip transports: it puts a fresh mix state (``make(x0)``, the
    backend's initializer) into the state's ``cstate`` slot(s), and the
    step threads it through ``compression.mix_with_state``.  None means
    only stateless transports can drive it.

    ``outer_traced(state, full_data)`` / ``end_outer_traced(state, k)`` are
    the transitions the resident runner applies between staged steps, with
    the dataset passed explicitly (the staged device copy) and ``k`` a
    float32 value; ``device_state(state)`` gives the initial state the
    fixed structure those transitions expect.
    """
    meta: AlgoMeta
    init: Callable[[], Any]
    step: Callable[[Any, Any, Any, Any], Any]   # (state, batch, phi, alpha)
    outer: Callable[[Any], Any] | None = None
    end_outer: Callable[[Any, int], Any] | None = None
    rule: UpdateRule | None = None
    init_mix_state: Callable[..., Any] | None = None
    outer_traced: Callable[[Any, Any], Any] | None = None
    end_outer_traced: Callable[[Any, Any], Any] | None = None
    device_state: Callable[[Any], Any] | None = None

    @staticmethod
    def get_params(state):
        return state.params


class ParamState(NamedTuple):
    params: Any


class DPSVRGState(NamedTuple):
    params: Any
    anchor: Any                       # snapshot point for the NEXT refresh
    est: svrg.SvrgState | None        # current snapshot + full gradient
    inner_sum: Any                    # tail-average accumulator (line 13)
    cstate: Any                       # transport state (None: stateless)


class GTSVRGState(NamedTuple):
    params: Any
    anchor: Any
    est: svrg.SvrgState | None
    tracker: Any                      # gradient-tracking direction y_i
    v_prev: Any
    inner_sum: Any
    cstate: Any = None                # (iterate, tracker) error-feedback pair


class LooplessState(NamedTuple):
    params: Any
    est: svrg.SvrgState
    cstate: Any = None                # compression error-feedback state


def _zeros_like(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def _svrg_outer_traced(loss_fn: Callable) -> Callable:
    """snapshot <- anchor, full_grad <- grad at anchor over the full data,
    inner_sum <- 0, with the dataset passed explicitly."""
    node_grad = build_node_grad_fn(loss_fn)

    def outer_traced(state, full_data):
        est = svrg.SvrgState(snapshot=state.anchor,
                             full_grad=node_grad(state.anchor, full_data))
        return state._replace(est=est, inner_sum=_zeros_like(state.params))

    return outer_traced


def _tail_average_end_outer_traced(state, k):
    """anchor <- inner_sum / K (Algorithm 1 line 13), K a float32 value."""
    return state._replace(
        anchor=pytree.tree_map(lambda acc: acc / k, state.inner_sum))


def _loopless_outer_traced(loss_fn: Callable) -> Callable:
    """Coin-flip snapshot refresh at the CURRENT iterate (L-SVRG style),
    with the dataset passed explicitly."""
    node_grad = build_node_grad_fn(loss_fn)

    def outer_traced(state, full_data):
        return state._replace(est=svrg.SvrgState(
            snapshot=state.params,
            full_grad=node_grad(state.params, full_data)))

    return outer_traced


def _svrg_placeholder_state(state):
    """Fill ``est=None`` with a zero ``SvrgState`` placeholder (overwritten
    by the first outer transition before any step reads it)."""
    if state.est is not None:
        return state
    est = svrg.SvrgState(snapshot=state.anchor,
                         full_grad=_zeros_like(state.params))
    return state._replace(est=est)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------

def dpsvrg_algorithm(problem: Problem, hp: DPSVRGHyperParams) -> Algorithm:
    """Paper Algorithm 1: SVRG-corrected prox step + multi-consensus gossip,
    growing inner rounds K_s = ceil(beta^s n0), tail-average snapshots."""
    inner = build_dpsvrg_inner_step(problem.loss_fn, problem.prox,
                                    compress_bits=hp.compress_bits)
    full_grad_fn = build_node_full_grad_fn(problem.loss_fn, problem.full_data)

    def init():
        cstate = (compression.init_state(problem.x0)
                  if hp.compress_bits is not None else None)
        return DPSVRGState(params=problem.x0, anchor=problem.x0, est=None,
                           inner_sum=_zeros_like(problem.x0), cstate=cstate)

    def init_mix_state(state, make=compression.init_state):
        return state._replace(cstate=make(problem.x0))

    def outer(state):
        est = svrg.SvrgState(snapshot=state.anchor,
                             full_grad=full_grad_fn(state.anchor))
        return state._replace(est=est, inner_sum=_zeros_like(state.params))

    def with_inner(inner_fn):
        def step(state, batch, phi, alpha):
            params, cstate = inner_fn(state.params, state.est, batch, phi,
                                      alpha, state.cstate)
            return state._replace(
                params=params, cstate=cstate,
                inner_sum=svrg.tree_add(state.inner_sum, params))
        return step

    def fused_step(mode):
        return with_inner(build_fused_svrg_inner(problem.loss_fn,
                                                 problem.prox, mode))

    def end_outer(state, K):
        return state._replace(
            anchor=pytree.tree_map(lambda acc: acc / K, state.inner_sum))

    if hp.single_consensus:
        rounds = lambda k: 1
    elif hp.k_max is None:
        rounds = lambda k: k
    else:
        rounds = lambda k: min(k, hp.k_max)

    meta = AlgoMeta(
        name="dpsvrg",
        stepsize=schedules.constant(hp.alpha),
        outer_lengths=tuple(
            schedules.inner_loop_lengths(hp.beta, hp.n0, hp.num_outer)),
        batch_size=hp.batch_size,
        step_grad_factor=2,
        outer_full_grad=True,
        gossip_rounds=rounds,
        track_consensus=True,
        comm_metric="gossip",
        record_key="round",
        final_record=True,
        compress_bits=hp.compress_bits,
        # hp-level quantization threads error feedback through every mix:
        # no fused lowering exists for it
        fused_step=None if hp.compress_bits is not None else fused_step,
    )
    return Algorithm(meta=meta, init=init, step=with_inner(inner),
                     outer=outer, end_outer=end_outer, rule=DPSVRG_RULE,
                     init_mix_state=init_mix_state,
                     outer_traced=_svrg_outer_traced(problem.loss_fn),
                     end_outer_traced=_tail_average_end_outer_traced,
                     device_state=_svrg_placeholder_state)


def dspg_algorithm(problem: Problem, hp: DSPGHyperParams,
                   num_steps: int) -> Algorithm:
    """DSPG baseline: one stochastic prox-gradient + one gossip per step."""
    step_fn = build_dspg_step(problem.loss_fn, problem.prox)

    def step(state, batch, phi, alpha):
        return ParamState(step_fn(state.params, batch, phi, alpha))

    def fused_step(mode):
        fstep_fn = build_fused_sgd_step(problem.loss_fn, problem.prox, mode)

        def fstep(state, batch, phi, alpha):
            return ParamState(fstep_fn(state.params, batch, phi, alpha))

        return fstep

    meta = AlgoMeta(
        name="dspg",
        stepsize=(schedules.constant(hp.alpha0) if hp.constant_step
                  else schedules.dspg_stepsize(hp.alpha0, hp.decay)),
        num_steps=num_steps,
        batch_size=hp.batch_size,
        step_grad_factor=1,
        slot_start=1,
        track_consensus=True,
        fused_step=fused_step,
    )
    return Algorithm(meta=meta, init=lambda: ParamState(problem.x0),
                     step=step, rule=DSPG_RULE)


def dpg_algorithm(problem: Problem, alpha: float, num_steps: int) -> Algorithm:
    """DPG [paper ref. 10]: deterministic full local gradients, one gossip +
    prox per step.  The smooth anchor: one effective epoch per step."""
    full_grad_fn = build_node_full_grad_fn(problem.loss_fn, problem.full_data)
    prox = problem.prox

    def _step(params, phi, a):
        return prox_gossip_update(params, full_grad_fn(params), phi, a, prox)

    def step(state, batch, phi, alpha):
        return ParamState(_step(state.params, phi, alpha))

    def fused_step(mode):
        def fstep(state, batch, phi, alpha):
            if gossip.phi_node_axis(phi) is not None:
                out = _sharded_sgd_step(
                    mode, prox, phi, state.params,
                    lambda: full_grad_fn(state.params), alpha)
                return ParamState(_step(state.params, phi, alpha)
                                  if out is None else out)
            w, spec = _fused_fallback(mode, prox, phi, None, state.params)
            if w is None:
                return ParamState(_step(state.params, phi, alpha))
            kind, lam = spec
            return ParamState(fused_ops.fused_resident_step(
                w, state.params, (full_grad_fn(state.params),), alpha, lam,
                rule="sgd", prox_kind=kind))

        return fstep

    meta = AlgoMeta(
        name="dpg",
        stepsize=schedules.constant(alpha),
        num_steps=num_steps,
        batch_size=0,
        step_grad_factor=0,
        slot_start=1,
        epoch_metric="steps",
        fused_step=fused_step,
    )
    return Algorithm(meta=meta, init=lambda: ParamState(problem.x0),
                     step=step)


def gt_svrg_algorithm(problem: Problem, alpha: float, num_outer: int,
                      inner_steps: int, batch_size: int = 1) -> Algorithm:
    """GT-SVRG [paper refs 18/19]: SVRG estimator + gradient tracking; one
    gossip round per step (tracking replaces multi-consensus).  No fused
    twin: the step mixes two quantities."""
    inner = build_gt_svrg_inner_step(problem.loss_fn, problem.prox)
    full_grad_fn = build_node_full_grad_fn(problem.loss_fn, problem.full_data)

    def init():
        # standard GT init: the tracker starts at the x0 full gradient
        est = svrg.SvrgState(snapshot=problem.x0,
                             full_grad=full_grad_fn(problem.x0))
        return GTSVRGState(params=problem.x0, anchor=problem.x0, est=est,
                           tracker=est.full_grad, v_prev=est.full_grad,
                           inner_sum=_zeros_like(problem.x0))

    def init_mix_state(state, make=compression.init_state):
        # one transport state per transmitted quantity
        return state._replace(cstate=(make(problem.x0), make(problem.x0)))

    def outer(state):
        est = svrg.SvrgState(snapshot=state.anchor,
                             full_grad=full_grad_fn(state.anchor))
        return state._replace(est=est, inner_sum=_zeros_like(state.params))

    def step(state, batch, phi, alpha):
        params, tracker, v_prev, cstate = inner(
            state.params, state.tracker, state.v_prev, state.est, batch,
            phi, alpha, state.cstate)
        return state._replace(
            params=params, tracker=tracker, v_prev=v_prev, cstate=cstate,
            inner_sum=svrg.tree_add(state.inner_sum, params))

    def end_outer(state, K):
        return state._replace(
            anchor=pytree.tree_map(lambda acc: acc / K, state.inner_sum))

    meta = AlgoMeta(
        name="gt_svrg",
        stepsize=schedules.constant(alpha),
        outer_lengths=(inner_steps,) * num_outer,
        batch_size=batch_size,
        step_grad_factor=2,
        outer_full_grad=True,
        gossip_payloads=2,   # the step mixes the iterate AND the tracker
        record_key="global",
        final_record=False,
    )
    return Algorithm(meta=meta, init=init, step=step, outer=outer,
                     end_outer=end_outer, rule=DPSVRG_RULE,
                     init_mix_state=init_mix_state,
                     outer_traced=_svrg_outer_traced(problem.loss_fn),
                     end_outer_traced=_tail_average_end_outer_traced)


def _loopless_family(problem: Problem, name: str, inner: Callable,
                     finner_for: Callable[[str], Callable], *, alpha: float,
                     num_steps: int, snapshot_prob: float, batch_size: int,
                     gossip_rounds: Callable[[int], int]) -> Algorithm:
    """Flat loop with coin-flip snapshot refreshes at the current iterate:
    loopless DPSVRG and DVR differ only in their inner step."""
    full_grad_fn = build_node_full_grad_fn(problem.loss_fn, problem.full_data)

    def init():
        est = svrg.SvrgState(snapshot=problem.x0,
                             full_grad=full_grad_fn(problem.x0))
        return LooplessState(params=problem.x0, est=est)

    def init_mix_state(state, make=compression.init_state):
        return state._replace(cstate=make(problem.x0))

    def outer(state):
        return state._replace(est=svrg.SvrgState(
            snapshot=state.params, full_grad=full_grad_fn(state.params)))

    def with_inner(inner_fn):
        def step(state, batch, phi, alpha):
            params, cstate = inner_fn(state.params, state.est, batch, phi,
                                      alpha, state.cstate)
            return state._replace(params=params, cstate=cstate)
        return step

    meta = AlgoMeta(
        name=name,
        stepsize=schedules.constant(alpha),
        num_steps=num_steps,
        batch_size=batch_size,
        step_grad_factor=2,
        outer_full_grad=True,
        init_full_grad=True,
        gossip_rounds=gossip_rounds,
        snapshot_prob=snapshot_prob,
        fused_step=lambda mode: with_inner(finner_for(mode)),
    )
    return Algorithm(meta=meta, init=init, step=with_inner(inner),
                     outer=outer, rule=DPSVRG_RULE,
                     init_mix_state=init_mix_state,
                     outer_traced=_loopless_outer_traced(problem.loss_fn))


def loopless_dpsvrg_algorithm(problem: Problem, alpha: float, num_steps: int,
                              snapshot_prob: float = 0.05,
                              consensus_rounds: int = 2,
                              batch_size: int = 1) -> Algorithm:
    """BEYOND-PAPER: L-SVRG-style coin-flip snapshots — fixed-shape steps,
    no outer-loop bookkeeping."""
    return _loopless_family(
        problem, "loopless_dpsvrg",
        build_dpsvrg_inner_step(problem.loss_fn, problem.prox),
        lambda mode: build_fused_svrg_inner(problem.loss_fn, problem.prox,
                                            mode),
        alpha=alpha, num_steps=num_steps, snapshot_prob=snapshot_prob,
        batch_size=batch_size, gossip_rounds=lambda t: consensus_rounds)


def dvr_algorithm(problem: Problem, alpha: float, num_steps: int,
                  rho: float = 0.5, snapshot_prob: float = 0.05,
                  batch_size: int = 1) -> Algorithm:
    """Dual-Free DVR (Hendrikx et al., arXiv 2006.14384) — see
    :func:`build_dvr_inner_step`.  Flat loop with loopless coin-flip
    snapshot refreshes; one gossip round per step with communication step
    size ``rho``."""
    return _loopless_family(
        problem, "dvr",
        build_dvr_inner_step(problem.loss_fn, problem.prox, rho),
        lambda mode: build_fused_svrg_inner(problem.loss_fn, problem.prox,
                                            mode, rho=rho),
        alpha=alpha, num_steps=num_steps, snapshot_prob=snapshot_prob,
        batch_size=batch_size, gossip_rounds=lambda t: 1)


ALGORITHMS: dict[str, Callable[..., Algorithm]] = {
    "dpsvrg": dpsvrg_algorithm,
    "dspg": dspg_algorithm,
    "dpg": dpg_algorithm,
    "gt_svrg": gt_svrg_algorithm,
    "loopless_dpsvrg": loopless_dpsvrg_algorithm,
    "dvr": dvr_algorithm,
}
