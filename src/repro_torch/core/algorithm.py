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
:mod:`repro_torch.core.runner` consumes this protocol.  Ported so far:
DPSVRG (paper Algorithm 1) and DSPG [paper ref. 11], each with its fused
twin, whose inner update runs through the fused resident-step kernel
(``kernels.fused_update``).

PyTorch runs eagerly, so the reference's step memoization
(``_shared_step``), which existed to keep XLA executables warm across
rebuilt algorithms, has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import gossip, prox as prox_lib, schedules, svrg, transport
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
    "DPSVRGHyperParams",
    "DSPGHyperParams",
    "build_node_grad_fn",
    "build_node_full_grad_fn",
    "build_dpsvrg_inner_step",
    "build_dspg_step",
    "build_fused_svrg_inner",
    "build_fused_sgd_step",
    "dpsvrg_algorithm",
    "dspg_algorithm",
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
    compress_bits: int | None = None  # int-quantized gossip (not ported yet)


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
    cstate)``: Algorithm 1 lines 7-11 for all nodes at once.  ``cstate`` is
    the compressed-gossip state of the reference; no stateful transport is
    ported, so it passes through as ``None``."""
    if compress_bits is not None:
        raise NotImplementedError(
            "compress_bits (quantized gossip with error feedback) is not "
            "ported to PyTorch yet (ROADMAP Queue 1 item 7)")
    node_grad = build_node_grad_fn(loss_fn)

    def step(params, svrg_state, batch, phi, alpha, cstate):
        v = svrg.corrected_gradient(node_grad, params, svrg_state, batch)
        return prox_gossip_update(params, v, phi, alpha, prox), cstate

    return step


def build_dspg_step(loss_fn: Callable, prox: prox_lib.Prox):
    """DSPG [paper ref. 11]: plain stochastic gradient + single gossip + prox,
    decaying step size."""
    node_grad = build_node_grad_fn(loss_fn)

    def step(params, batch, w, alpha):
        return prox_gossip_update(params, node_grad(params, batch), w, alpha,
                                  prox)

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
#   returns None),
# * a stateful transport threads a mix state (cstate is not None),
# * the prox has no ``fused_spec`` (only l1 / sql2 / none lower),
# * kernel="auto" at per-node sizes where the unfused step wins
#   (``fused_ops.fused_wins``).

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


def build_fused_svrg_inner(loss_fn: Callable, prox: prox_lib.Prox,
                           mode: str):
    """Fused twin of ``build_dpsvrg_inner_step``, same signature:
    ``inner(params, est, batch, phi, alpha, cstate) -> (params, cstate)``."""
    base = build_dpsvrg_inner_step(loss_fn, prox)
    node_grad = build_node_grad_fn(loss_fn)

    def inner(params, est, batch, phi, alpha, cstate):
        w, spec = _fused_fallback(mode, prox, phi, cstate, params)
        if w is None:
            return base(params, est, batch, phi, alpha, cstate)
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
    prox(W @ (x - alpha*g))."""
    base = build_dspg_step(loss_fn, prox)
    node_grad = build_node_grad_fn(loss_fn)

    def step_fn(params, batch, phi, alpha):
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
        return DPSVRGState(params=problem.x0, anchor=problem.x0, est=None,
                           inner_sum=_zeros_like(problem.x0), cstate=None)

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
        fused_step=fused_step,
    )
    return Algorithm(meta=meta, init=init, step=with_inner(inner),
                     outer=outer, end_outer=end_outer, rule=DPSVRG_RULE,
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


ALGORITHMS: dict[str, Callable[..., Algorithm]] = {
    "dpsvrg": dpsvrg_algorithm,
    "dspg": dspg_algorithm,
}
