"""Inexact Prox-SVRG (paper Algorithm 2) and an executable Theorem 1.

The port of ``repro.core.inexact``.  Algorithm 2 is the centralized
reformulation of DPSVRG: a virtual node holds the average parameter and
runs Prox-SVRG with two injected error sequences, the gradient error
``e^(k,s)`` (Eq. 10a) and the proximal error ``eps^(k,s)`` (Eq. 10b), which
absorb the dissensus of the decentralized copies.

* ``inexact_prox_svrg_algorithm`` — Algorithm 2 as an ``Algorithm`` of the
  protocol (one virtual node: stacked trees with m = 1, identity gossip),
  registered as ``algorithm.ALGORITHMS["inexact_prox_svrg"]``.  The state
  carries the global step counter as a 0-d int32 tensor, which drives the
  injected gradient error; with no error model (or a torch-traceable one)
  it runs on the resident path and in batched sweeps too.
* ``inexact_prox_svrg_run`` — a thin entry over ``runner.run`` with the
  reference's (final_params, objective_history) return.
* ``verify_theorem1`` — runs DPSVRG (Algorithm 1) through ``runner.run``'s
  host loop with a diagnostic step wrapper that checks, step by step,
  the constructive content of Theorem 1:
    (i)   with ``e`` from Eq. (10a), the Algorithm-2 gradient step
          reproduces the node-average pre-consensus iterate:
          q̄ = x̄ − α(v + e);
    (ii)  gossip preserves the node average (doubly stochastic Φ);
    (iii) x̄^(k,s) is an ε-inexact prox of q̄ with ε from Eq. (10b): the
          inexactness inequality (9) holds with that ε.
  The Eq. (10b) epsilon needs a subgradient p ∈ ∂h(x̄), taken from the
  prox's ``subgrad``; a prox without one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import (algorithm as algorithm_lib, gossip, graphs, prox as prox_lib,
               runner as runner_lib, schedules, svrg)
from .algorithm import (AlgoMeta, Algorithm, DPSVRGHyperParams, Problem,
                        build_node_full_grad_fn, build_node_grad_fn,
                        prox_gossip_update)
from .exec_spec import ExecSpec

__all__ = [
    "InexactHyperParams",
    "InexactState",
    "inexact_prox_svrg_algorithm",
    "inexact_prox_svrg_run",
    "verify_theorem1",
    "Theorem1Diagnostics",
]


# ---------------------------------------------------------------------------
# Algorithm 2 on the protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InexactHyperParams:
    """Algorithm 2 shares Algorithm 1's loop geometry (K_s = ceil(beta^s n0),
    constant step, tail-average snapshots) on a single virtual node."""
    alpha: float = 0.01
    beta: float = 1.07
    n0: int = 8
    num_outer: int = 30
    batch_size: int = 1


class InexactState(NamedTuple):
    params: Any                  # stacked (1, ...) virtual-node iterate
    anchor: Any                  # snapshot point for the NEXT refresh
    est: svrg.SvrgState | None   # current snapshot + full gradient
    inner_sum: Any               # tail-average accumulator
    t: Any                       # global step counter, 0-d int32 tensor


def _zeros_like(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def inexact_prox_svrg_algorithm(problem: Problem, hp: InexactHyperParams,
                                grad_error_fn: Callable | None = None
                                ) -> Algorithm:
    """Paper Algorithm 2 as an :class:`Algorithm`.

    ``problem`` is a stacked problem with m = 1 (the virtual node holding
    the average); drive it with an identity schedule, e.g.
    ``graphs.static_schedule(np.eye(1))``.  ``grad_error_fn(t, params) ->
    tree`` injects the Eq. (10a) gradient error e^(k,s) at global step t (a
    0-d int32 tensor, 0-based) given the UNSTACKED iterate; None means
    exact.  An error model that leaves torch (numpy, Python floats) needs
    the host loop.  The proximal error eps^(k,s) is not injected: the prox
    operators are exact closed forms, and Algorithm 2's eps models the
    decentralized prox gap, which ``verify_theorem1`` measures on the real
    DPSVRG run.
    """
    full_grad_fn = build_node_full_grad_fn(problem.loss_fn, problem.full_data)
    node_grad = build_node_grad_fn(problem.loss_fn)
    prox = problem.prox

    def init():
        leaf = pytree.tree_leaves(problem.x0)[0]
        return InexactState(params=problem.x0, anchor=problem.x0, est=None,
                            inner_sum=_zeros_like(problem.x0),
                            t=torch.zeros((), dtype=torch.int32,
                                          device=leaf.device))

    def outer(state):
        est = svrg.SvrgState(snapshot=state.anchor,
                             full_grad=full_grad_fn(state.anchor))
        return state._replace(est=est, inner_sum=_zeros_like(state.params))

    def step(state, batch, phi, alpha):
        v = svrg.corrected_gradient(node_grad, state.params, state.est,
                                    batch)
        if grad_error_fn is not None:
            err = grad_error_fn(state.t, gossip.unstack_tree(state.params))
            v = pytree.tree_map(
                lambda vi, e: vi + torch.as_tensor(
                    e, dtype=vi.dtype, device=vi.device)[None], v, err)
        params = prox_gossip_update(state.params, v, phi, alpha, prox)
        return state._replace(
            params=params, t=state.t + 1,
            inner_sum=svrg.tree_add(state.inner_sum, params))

    def end_outer(state, K):
        return state._replace(
            anchor=pytree.tree_map(lambda acc: acc / K, state.inner_sum))

    meta = AlgoMeta(
        name="inexact_prox_svrg",
        stepsize=schedules.constant(hp.alpha),
        outer_lengths=tuple(
            schedules.inner_loop_lengths(hp.beta, hp.n0, hp.num_outer)),
        batch_size=hp.batch_size,
        step_grad_factor=2,
        outer_full_grad=True,
        record_key="round",
        final_record=True,
    )
    return Algorithm(
        meta=meta, init=init, step=step, outer=outer, end_outer=end_outer,
        outer_traced=algorithm_lib._svrg_outer_traced(problem.loss_fn),
        end_outer_traced=algorithm_lib._tail_average_end_outer_traced,
        device_state=algorithm_lib._svrg_placeholder_state)


# Registered beside the decentralized methods: Algorithm 2 is one more
# Algorithm to the runner (importing this module registers it, and
# ``repro_torch.core`` imports it).
algorithm_lib.ALGORITHMS["inexact_prox_svrg"] = inexact_prox_svrg_algorithm


def inexact_prox_svrg_run(loss_fn: Callable,
                          prox: prox_lib.Prox,
                          x0,
                          full_data_flat,
                          alpha: float,
                          beta: float,
                          n0: int,
                          num_outer: int,
                          batch_size: int = 1,
                          grad_error_fn: Callable | None = None,
                          seed: int = 0,
                          objective_fn: Callable | None = None,
                          exec: "ExecSpec | None" = None):
    """Centralized Algorithm 2 through the unified runner.

    ``full_data_flat`` leaves: (n, ...) tensors; ``x0`` and
    ``grad_error_fn`` use the unstacked (centralized) parameter shape.
    ``exec`` is ``runner.run``'s (``None``: the host loop on the CUDA
    device; the tensors lie on its device).  Returns (final_params,
    objective_history np.ndarray over inner steps).
    """
    x0_st = pytree.tree_map(lambda a: a[None], x0)
    data_st = pytree.tree_map(lambda a: a[None], full_data_flat)
    obj = None
    if objective_fn is not None:
        obj = lambda p_st: objective_fn(gossip.unstack_tree(p_st))  # noqa
    problem = Problem(loss_fn, prox, x0_st, data_st, obj)
    hp = InexactHyperParams(alpha=alpha, beta=beta, n0=n0,
                            num_outer=num_outer, batch_size=batch_size)
    algo = inexact_prox_svrg_algorithm(problem, hp,
                                       grad_error_fn=grad_error_fn)
    sched = graphs.static_schedule(np.eye(1), name="centralized")
    res = runner_lib.run(algo, problem, sched, exec, seed=seed,
                         record_every=1)
    return gossip.unstack_tree(res.params), res.history.objective


# ---------------------------------------------------------------------------
# Executable Theorem 1: a diagnostic step wrapper over Algorithm 1
# ---------------------------------------------------------------------------

class Theorem1Diagnostics(NamedTuple):
    qbar_residual: np.ndarray   # || mean_i q_i  -  (x̄_prev - α(v+e)) ||  (claim i)
    mix_mean_residual: np.ndarray  # || mean_i q̂_i - mean_i q_i ||        (claim ii)
    eps: np.ndarray             # ε^(k,s) from Eq. (10b)
    ineq9_slack: np.ndarray     # RHS(9) - LHS(9) with that ε (≥ 0 ⇒ claim iii)
    grad_err_norm: np.ndarray   # ||e^(k,s)||  (for Assumption-6 summability)
    consensus: np.ndarray       # mean ||x_i - x̄||


def _tree_flat(tree) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in pytree.tree_leaves(tree)])


def _prox_subgradient(prox: prox_lib.Prox, tree):
    """A canonical p ∈ ∂h(x) from the prox's registered subgradient.

    Raises for proxes without one: Eq. (10b)'s eps (and the inequality-(9)
    slack built on it) would be wrong with h's subgradient taken as 0."""
    if prox.subgrad is None:
        raise NotImplementedError(
            f"prox '{prox.name}' registers no subgradient; Theorem-1's "
            f"Eq. (10b) eps needs p ∈ ∂h(x̄) — add a `subgrad` to the Prox "
            f"or use one of l1 / elastic_net / group_lasso / squared_l2")
    return prox.subgrad(tree)


def verify_theorem1(loss_fn: Callable,
                    prox: prox_lib.Prox,
                    x0_stacked,
                    full_data,
                    schedule: graphs.MixingSchedule,
                    hp: DPSVRGHyperParams,
                    seed: int = 0,
                    device="cuda") -> Theorem1Diagnostics:
    """Run Algorithm 1 via ``runner.run`` and check the Theorem-1
    construction at every inner step.

    A step wrapper around the stock ``dpsvrg_algorithm``: the wrapped step
    first advances the real algorithm, then recomputes the step's
    intermediates (v_i, q_i, q̂_i) from the same (state, batch, phi) to
    evaluate claims (i)-(iii).  Sampling, scheduling and accounting are
    therefore the production runner's.  The host loop on ``device`` (the
    CUDA device unless the caller asks for the CPU; the tensors lie
    there); requires uncompressed gossip.
    """
    if hp.compress_bits is not None:
        raise ValueError("verify_theorem1 checks the exact-gossip Theorem-1 "
                         "construction; quantized gossip (compress_bits) "
                         "does not preserve the node mean per step")
    node_grad = build_node_grad_fn(loss_fn)
    full_grad_fn = build_node_full_grad_fn(loss_fn, full_data)
    m = pytree.tree_leaves(x0_stacked)[0].shape[0]

    problem = Problem(loss_fn, prox, x0_stacked, full_data)
    algo = algorithm_lib.dpsvrg_algorithm(problem, hp)
    base_step = algo.step

    d_qbar, d_mix, d_eps, d_slack, d_enorm, d_cons = [], [], [], [], [], []

    def mean0(x):
        return x.mean(dim=0)

    def diagnostic_step(state, batch, phi, alpha):
        new_state = base_step(state, batch, phi, alpha)

        params, est = state.params, state.est
        xbar_prev = gossip.node_mean(params)

        # --- Algorithm 1 step intermediates, recomputed -------------------
        v_i = svrg.corrected_gradient(node_grad, params, est, batch)
        q_i = pytree.tree_map(lambda x, vv: x - hp.alpha * vv, params, v_i)
        q_hat = gossip.mix_stacked(phi, q_i)
        x_new = new_state.params

        # --- claim (i): the centralized v + e reproduce q̄ -----------------
        xbar_prev_st = gossip.stack_tree(xbar_prev, m)
        snapbar = gossip.node_mean(est.snapshot)
        snapbar_st = gossip.stack_tree(snapbar, m)
        g_xbar = node_grad(xbar_prev_st, batch)           # ∇f_i^{l_i}(x̄)
        g_snapbar = node_grad(snapbar_st, batch)          # ∇f_i^{l_i}(x̃)
        full_at_snap_i = est.full_grad                    # ∇f_i(x̃_i)
        full_at_snapbar = full_grad_fn(snapbar_st)        # ∇f_i(x̃)
        g_now = node_grad(params, batch)
        g_snap_i = node_grad(est.snapshot, batch)

        # Eq. (10a): e = mean_i[(∇f_i^l(x_i)-∇f_i^l(x̄))
        #                       + (∇f_i^l(x̃) - ∇f_i^l(x̃_i))
        #                       + (∇f_i(x̃_i) - ∇f_i(x̃))]
        e_tree = pytree.tree_map(
            lambda a, b, c, d_, e_, f_: mean0((a - b) + (c - d_) + (e_ - f_)),
            g_now, g_xbar, g_snapbar, g_snap_i, full_at_snap_i,
            full_at_snapbar)
        # centralized estimator v = mean_i[∇f_i^l(x̄) - ∇f_i^l(x̃) + ∇f_i(x̃)]
        v_central = pytree.tree_map(lambda a, b, c: mean0(a - b + c),
                                    g_xbar, g_snapbar, full_at_snapbar)
        qbar_from_alg2 = pytree.tree_map(
            lambda x, vv, ee: x - hp.alpha * (vv + ee),
            xbar_prev, v_central, e_tree)
        qbar_actual = gossip.node_mean(q_i)
        d_qbar.append(float(svrg.tree_norm(
            svrg.tree_sub(qbar_actual, qbar_from_alg2))))
        d_enorm.append(float(svrg.tree_norm(e_tree)))

        # --- claim (ii): doubly-stochastic mixing preserves the mean ------
        d_mix.append(float(svrg.tree_norm(
            svrg.tree_sub(gossip.node_mean(q_hat), qbar_actual))))

        # --- claim (iii): x̄ is an ε-inexact prox of q̄ --------------------
        xbar_new = gossip.node_mean(x_new)
        y = prox.apply(qbar_actual, hp.alpha)  # exact prox of q̄
        # Eq. (10b): ε = 1/(2α)||x̄-y||² + <x̄-y, (y-q̄)/α + p>, p ∈ ∂h(x̄)
        diff = _tree_flat(svrg.tree_sub(xbar_new, y))
        yq = _tree_flat(svrg.tree_sub(y, qbar_actual))
        p_vec = _tree_flat(_prox_subgradient(prox, xbar_new))
        eps = float(torch.vdot(diff, diff) / (2 * hp.alpha)
                    + torch.vdot(diff, yq / hp.alpha + p_vec))
        d_eps.append(eps)

        # inexactness inequality (9):
        # 1/(2α)||x̄-q̄||² + h(x̄) ≤ min_y {...} + ε
        def proxobj(pt):
            dd = _tree_flat(svrg.tree_sub(pt, qbar_actual))
            return float(torch.vdot(dd, dd) / (2 * hp.alpha)
                         + prox.value(pt))

        d_slack.append(proxobj(y) + eps - proxobj(xbar_new))
        d_cons.append(graphs.consensus_distance(np.stack(
            [_tree_flat(gossip.unstack_tree(x_new, i)).cpu().numpy()
             for i in range(m)])))
        return new_state

    wrapped = dataclasses.replace(algo, step=diagnostic_step)
    runner_lib.run(wrapped, problem, schedule, ExecSpec(device=device),
                   seed=seed, record_every=0)

    return Theorem1Diagnostics(
        qbar_residual=np.array(d_qbar),
        mix_mean_residual=np.array(d_mix),
        eps=np.array(d_eps),
        ineq9_slack=np.array(d_slack),
        grad_err_norm=np.array(d_enorm),
        consensus=np.array(d_cons))
