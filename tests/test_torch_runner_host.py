"""Whole-slice parity on the host loop: the port's DPSVRG and DSPG runs
against the JAX package's, on the quickstart problem (``adult_like`` at
scale 0.05, m = 8, l1(0.01)) over ``b_connected_ring_schedule(8, b)``.

Minibatches come from the same ``np.random.default_rng(seed)`` stream in
the same order on both sides.  Objective, consensus and final parameters
agree to rtol 1e-4 / atol 1e-6 (float32, sums in different orders,
compounded over the run); epochs, gossip rounds, steps, wire bytes and the
transfer ledger are exactly equal."""

import numpy as np
import pytest

from _torch_parity import (TExecSpec, assert_histories_match, build,
                           problems, run_jax, run_torch, talgorithm,
                           tgraphs, trunner)


@pytest.mark.parametrize("record_every", [0, 10])
@pytest.mark.parametrize("b", [1, 2])
def test_dpsvrg_host_loop_matches_reference(b, record_every):
    assert_histories_match(run_jax("dpsvrg", b, record_every),
                           run_torch("dpsvrg", b, record_every))


@pytest.mark.parametrize("record_every", [1, 10])
@pytest.mark.parametrize("b", [1, 2])
def test_dspg_host_loop_matches_reference(b, record_every):
    assert_histories_match(run_jax("dspg", b, record_every),
                           run_torch("dspg", b, record_every))


def test_flat_loop_needs_record_every_like_reference():
    with pytest.raises(ValueError, match="record_every >= 1"):
        run_jax("dspg", 1, 0)
    with pytest.raises(ValueError, match="record_every >= 1"):
        run_torch("dspg", 1, 0)


def test_extra_metrics_recorded_beside_history():
    """Host-side extra metrics see the recorded parameters and leave the
    history unchanged."""
    _, tp = problems()
    plain = run_torch("dpsvrg", 1, 10)
    res = trunner.run(build(talgorithm, "dpsvrg", tp), tp,
                      tgraphs.b_connected_ring_schedule(8, 1),
                      TExecSpec(gossip="dense", device="cpu"),
                      record_every=10,
                      extra_metrics={"norm": lambda p: float(p.norm())})
    np.testing.assert_array_equal(res.history.objective,
                                  plain.history.objective)
    assert res.extras["norm"].shape == plain.history.objective.shape
    assert res.extras["norm"][-1] == float(plain.params.norm())
