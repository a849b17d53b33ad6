"""Whole-slice parity on the resident path: the port's resident runner with
the fused step (``kernel="fused"``, which on CPU tensors runs the kernel's
plain version) against the JAX package's resident runner with
``kernel="pallas"`` (which runs its jnp oracle off the TPU), plus the
port's own consistency across its kernel modes and transition folding.

Same problem and tolerance as ``test_torch_runner_host.py``: objective,
consensus and final parameters to rtol 1e-4 / atol 1e-6; epochs, gossip
rounds, steps, wire bytes and the transfer ledger exactly equal, but for
one departure: the port gathers minibatches on the device, so it pulls
only the history (one staging transfer in, one pull out), where the
reference also pulls the dataset."""

import numpy as np
import pytest

from _torch_parity import (TExecSpec, assert_histories_match, build,
                           problems, run_jax, run_torch, talgorithm,
                           tgraphs, trunner)
from repro_torch.kernels.fused_update import ops


@pytest.mark.parametrize("record_every", [0, 10])
@pytest.mark.parametrize("b", [1, 2])
def test_dpsvrg_resident_fused_matches_reference(b, record_every):
    want = run_jax("dpsvrg", b, record_every, resident=True, kernel="pallas")
    got = run_torch("dpsvrg", b, record_every, resident=True, kernel="fused")
    assert_histories_match(want, got, device_gather=True)
    assert (got.extras["transfers_h2d"], got.extras["transfers_d2h"]) \
        == (1, 1)


@pytest.mark.parametrize("record_every", [1, 10])
@pytest.mark.parametrize("b", [1, 2])
def test_dspg_resident_fused_matches_reference(b, record_every):
    assert_histories_match(
        run_jax("dspg", b, record_every, resident=True, kernel="pallas"),
        run_torch("dspg", b, record_every, resident=True, kernel="fused"),
        device_gather=True)


@pytest.mark.parametrize("name,record_every", [("dpsvrg", 0), ("dspg", 10)])
def test_resident_plain_matches_reference(name, record_every):
    assert_histories_match(
        run_jax(name, 2, record_every, resident=True),
        run_torch(name, 2, record_every, resident=True, kernel="plain"),
        device_gather=True)


@pytest.mark.parametrize("transitions", [True, False])
def test_outer_transitions_folded_or_not_agree(transitions):
    """Outer rounds applied from the plan's per-step flags or as host ops
    between chunks give the same run (the reference's
    device_transitions=True/False)."""
    folded = run_torch("dpsvrg", 1, 10, resident=True, kernel="fused")
    other = run_torch("dpsvrg", 1, 10, resident=True, kernel="fused",
                      device_transitions=transitions)
    np.testing.assert_array_equal(other.history.objective,
                                  folded.history.objective)
    np.testing.assert_array_equal(other.params.numpy(),
                                  folded.params.numpy())


@pytest.mark.parametrize("name", ["dpsvrg", "dspg"])
def test_auto_below_threshold_runs_the_plain_step(name, monkeypatch):
    """kernel="auto" keeps the unfused step below FUSED_MIN_D (d = 30 here)
    and takes the fused one at or above it."""
    record_every = 0 if name == "dpsvrg" else 10
    plain = run_torch(name, 1, record_every, resident=True, kernel="plain")
    fused = run_torch(name, 1, record_every, resident=True, kernel="fused")
    monkeypatch.setattr(ops, "FUSED_MIN_D", 31)
    auto = run_torch(name, 1, record_every, resident=True, kernel="auto")
    np.testing.assert_array_equal(auto.history.objective,
                                  plain.history.objective)
    monkeypatch.setattr(ops, "FUSED_MIN_D", 30)
    auto = run_torch(name, 1, record_every, resident=True, kernel="auto")
    np.testing.assert_array_equal(auto.history.objective,
                                  fused.history.objective)


def test_resident_matches_host_loop():
    host = run_torch("dpsvrg", 2, 10)
    resident = run_torch("dpsvrg", 2, 10, resident=True, kernel="fused")
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(resident.history, field),
                                      getattr(host.history, field))
    np.testing.assert_array_equal(resident.extras["wire_bytes"],
                                  host.extras["wire_bytes"])
    np.testing.assert_allclose(resident.history.objective,
                               host.history.objective, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(resident.history.consensus,
                               host.history.consensus, rtol=1e-4, atol=1e-7)


def test_resident_refuses_host_extra_metrics():
    _, tp = problems()
    with pytest.raises(ValueError, match="extra_metrics"):
        trunner.run(build(talgorithm, "dspg", tp), tp,
                    tgraphs.b_connected_ring_schedule(8, 1),
                    TExecSpec(resident=True, gossip="dense", device="cpu"),
                    record_every=10, extra_metrics={"x": lambda p: 0.0})
