"""Algorithm 2 and the executable Theorem 1 of the port
(``repro_torch.core.inexact``) against the JAX package's
``repro.core.inexact``, on the CPU, on the reference's own problem
(``tests/test_inexact_equivalence.py``: m = 4 nodes, n = 128, d = 12).

Theorem 1's diagnostics are float32 computations on O(1) iterates, so
they are held to the JAX package's per step within absolute tolerances of
a few float32 ulps of O(1) terms: 1e-7 for the gradient-error norms and the
consensus distances (values 1e-4 to 1e-2), 1e-9 for eps (values near 1e-6,
a difference of near-equal squared norms).  The two residuals of claims (i)
and (ii) are float32 round-off in both packages, so each package is held
below the reference's bound, 1e-5, as is the slack of inequality (9).
Histories of Algorithm 2 use the runner parity tolerance (rtol 1e-4, atol
1e-6).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import algorithm as jalgorithm, dpsvrg as jdpsvrg, \
    graphs as jgraphs, inexact as jinexact, prox as jprox, runner as jrunner
from repro.data import synthetic
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    inexact as tinexact, prox as tprox, runner as trunner
from repro_torch.core.exec_spec import ExecSpec as TExecSpec

torch.set_num_threads(1)

M, D = 4, 12
NORM_ATOL = 1e-7
EPS_ATOL = 1e-9
RESIDUAL_MAX = 1e-5
HISTORY_TOL = dict(rtol=1e-4, atol=1e-6)


def jax_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return jnp.mean(-y * logits + jnp.log1p(jnp.exp(logits)))


def torch_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))


def _parts():
    ds = synthetic.make_classification(n=128, d=D, seed=0)
    return synthetic.partition_per_node(ds, M)


def _diagnostics(jh, th, num_outer):
    parts = _parts()
    kw = dict(alpha=0.3, beta=1.2, n0=4, num_outer=num_outer)
    want = jinexact.verify_theorem1(
        jax_loss, jh, jnp.zeros((M, D)),
        {k: jnp.asarray(v) for k, v in parts.items()},
        jgraphs.b_connected_ring_schedule(M, b=1),
        jdpsvrg.DPSVRGHyperParams(**kw))
    got = tinexact.verify_theorem1(
        torch_loss, th, torch.zeros(M, D), params_from_numpy(parts, "cpu"),
        tgraphs.b_connected_ring_schedule(M, b=1),
        talgorithm.DPSVRGHyperParams(**kw), device="cpu")
    return want, got


@pytest.mark.parametrize("which", ["l1", "elastic_net"])
def test_theorem1_diagnostics_match_jax(which):
    if which == "l1":
        want, got = _diagnostics(jprox.l1(0.01), tprox.l1(0.01), 6)
    else:
        want, got = _diagnostics(jprox.elastic_net(0.01, 0.05),
                                 tprox.elastic_net(0.01, 0.05), 5)
    assert got._fields == want._fields
    for f in got._fields:
        assert np.asarray(getattr(got, f)).shape == \
            np.asarray(getattr(want, f)).shape, f
    np.testing.assert_allclose(got.eps, want.eps, rtol=0, atol=EPS_ATOL)
    for f in ("grad_err_norm", "consensus"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=NORM_ATOL, err_msg=f)
    for diag in (want, got):
        # (i) Eq. 10a reproduces the node-average pre-consensus iterate
        assert diag.qbar_residual.max() < RESIDUAL_MAX
        # (ii) doubly-stochastic mixing preserves the mean
        assert diag.mix_mean_residual.max() < RESIDUAL_MAX
        # (iii) the inexactness inequality (9) holds with eps of Eq. 10b
        assert diag.ineq9_slack.min() > -RESIDUAL_MAX
    # the reference's claims on the port's run: bounded, non-growing errors
    q = max(len(got.eps) // 4, 1)
    assert np.abs(got.eps).max() < 1e-2
    assert np.abs(got.eps[-q:]).mean() <= np.abs(got.eps[:q]).mean() + 1e-4
    assert got.grad_err_norm.max() < 1.0
    assert got.consensus[-1] < 1e-2


def test_theorem1_raises_without_subgradient():
    """A prox with no registered subgradient fails loudly, not with p = 0;
    quantized gossip is refused too."""
    parts = params_from_numpy(_parts(), "cpu")
    sched = tgraphs.b_connected_ring_schedule(M, b=1)
    hp = talgorithm.DPSVRGHyperParams(alpha=0.3, beta=1.2, n0=2,
                                      num_outer=1)
    with pytest.raises(NotImplementedError, match="subgradient"):
        tinexact.verify_theorem1(torch_loss, tprox.nuclear(0.01),
                                 torch.zeros(M, D), parts, sched, hp,
                                 device="cpu")
    with pytest.raises(ValueError, match="compress_bits"):
        tinexact.verify_theorem1(
            torch_loss, tprox.l1(0.01), torch.zeros(M, D), parts, sched,
            talgorithm.DPSVRGHyperParams(compress_bits=8), device="cpu")


def _flat_problems():
    flat = {k: v.reshape(1, -1, *v.shape[2:]) for k, v in _parts().items()}
    jp = jalgorithm.Problem(jax_loss, jprox.l1(0.01), jnp.zeros((1, D)),
                            {k: jnp.asarray(v) for k, v in flat.items()})
    tp = talgorithm.Problem(torch_loss, tprox.l1(0.01), torch.zeros(1, D),
                            params_from_numpy(flat, "cpu"))
    return jp, tp


@pytest.mark.parametrize("resident", [False, True])
def test_algorithm2_through_the_runner_matches_jax(resident):
    """Algorithm 2 is a registry entry: the same runner drives it, on the
    host loop and on the resident path, as in the JAX package."""
    jp, tp = _flat_problems()
    kw = dict(alpha=0.5, beta=1.2, n0=4, num_outer=6)
    jalgo = jalgorithm.ALGORITHMS["inexact_prox_svrg"](
        jp, jinexact.InexactHyperParams(**kw))
    talgo = talgorithm.ALGORITHMS["inexact_prox_svrg"](
        tp, tinexact.InexactHyperParams(**kw))
    want = jrunner.run(jalgo, jp,
                       jgraphs.static_schedule(np.eye(1), "centralized"),
                       seed=0, record_every=1).history
    got = trunner.run(talgo, tp,
                      tgraphs.static_schedule(np.eye(1), "centralized"),
                      TExecSpec(device="cpu", resident=resident), seed=0,
                      record_every=1).history
    for f in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_allclose(got.objective, want.objective, **HISTORY_TOL)
    assert got.objective[-1] < got.objective[0] - 0.05


def test_inexact_run_with_injected_errors_matches_jax():
    """``inexact_prox_svrg_run`` with the same summable gradient errors
    (a seeded numpy table indexed by the step counter) in both packages,
    and with none: the histories agree, and both converge."""
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in _parts().items()}
    table = (np.random.default_rng(0).normal(size=(400, D))
             * 0.05 * 0.5 ** (np.arange(400)[:, None] / 10)).astype(
                 np.float32)
    kw = dict(alpha=0.5, beta=1.2, n0=4, num_outer=10)

    def jerr(t, params):
        return jnp.asarray(table[int(t)])

    def terr(t, params):
        return torch.from_numpy(table[int(t)])

    for with_err in (False, True):
        _, want = jinexact.inexact_prox_svrg_run(
            jax_loss, jprox.l1(0.01), jnp.zeros(D),
            {k: jnp.asarray(v) for k, v in flat.items()},
            grad_error_fn=jerr if with_err else None, **kw)
        x, got = tinexact.inexact_prox_svrg_run(
            torch_loss, tprox.l1(0.01), torch.zeros(D),
            params_from_numpy(flat, "cpu"),
            grad_error_fn=terr if with_err else None,
            exec=TExecSpec(device="cpu"), **kw)
        assert tuple(x.shape) == (D,)
        np.testing.assert_allclose(got, np.asarray(want), **HISTORY_TOL)
        assert got[-1] < got[0] - 0.04
