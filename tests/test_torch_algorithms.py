"""The rest of the reference's algorithm registry in the port — loopless
DPSVRG, DVR, DPG and GT-SVRG — with coin-flip snapshots, on the dense,
banded and compressed transports.

Each port run is held against the JAX package's host loop on the same
numpy problem (``_torch_parity``): objective, consensus and final
parameters at rtol 1e-4 / atol 1e-6; epochs, gossip rounds, steps, wire
bytes and the transfer ledger exactly (equal epochs also pin the coin
flips: each refresh charges a full gradient).  The port's resident path is
held against its host loop, and its fused steps against its plain ones.
"""

import numpy as np
import pytest

from _torch_parity import (HISTORY_ATOL, HISTORY_RTOL, JExecSpec, M,
                           TExecSpec, assert_histories_match, jalgorithm,
                           jgraphs, jrunner, problems, talgorithm, tgraphs,
                           trunner)
from repro_torch.kernels.fused_update import ops

NAMES = ["loopless_dpsvrg", "dvr", "dpg", "gt_svrg"]
GOSSIP = ["dense", "banded", "compressed"]
FUSED = ["loopless_dpsvrg", "dvr", "dpg"]       # methods with a fused twin


def make(pkg, name, problem):
    if name == "loopless_dpsvrg":
        return pkg.loopless_dpsvrg_algorithm(problem, 0.2, 60,
                                             snapshot_prob=0.1)
    if name == "dvr":
        return pkg.dvr_algorithm(problem, 0.2, 60, rho=0.6,
                                 snapshot_prob=0.1)
    if name == "dpg":
        return pkg.dpg_algorithm(problem, 0.2, 30)
    return pkg.gt_svrg_algorithm(problem, 0.05, num_outer=3, inner_steps=10)


def run_jax(name, gossip, b=1, **spec):
    jp, _ = problems()
    return jrunner.run(make(jalgorithm, name, jp), jp,
                       jgraphs.b_connected_ring_schedule(M, b),
                       JExecSpec(gossip=gossip, **spec), seed=0,
                       record_every=10)


def run_torch(name, gossip, b=1, **spec):
    _, tp = problems()
    return trunner.run(make(talgorithm, name, tp), tp,
                       tgraphs.b_connected_ring_schedule(M, b),
                       TExecSpec(gossip=gossip, device="cpu", **spec),
                       seed=0, record_every=10)


def _same_run(want, got):
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field),
                                      err_msg=field)
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  want.extras["wire_bytes"])
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(got.history, col),
                                   getattr(want.history, col),
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                                   err_msg=col)
    np.testing.assert_allclose(got.params.numpy(), want.params.numpy(),
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


@pytest.mark.parametrize("gossip", GOSSIP)
@pytest.mark.parametrize("name", NAMES)
def test_host_loop_matches_reference(name, gossip):
    if name == "dpg" and gossip == "compressed":
        # DPG threads no mix state: both packages refuse, by the same rule
        with pytest.raises(ValueError, match="mix state"):
            run_jax(name, gossip)
        with pytest.raises(ValueError, match="mix state"):
            run_torch(name, gossip)
        return
    assert_histories_match(run_jax(name, gossip), run_torch(name, gossip))


@pytest.mark.parametrize("gossip", GOSSIP)
@pytest.mark.parametrize("name", NAMES)
def test_resident_matches_host_loop(name, gossip):
    """The resident plan draws the same indices and coins in the same order
    as the host loop; the fused step (where the method has one) runs its
    plain version on the CPU."""
    if name == "dpg" and gossip == "compressed":
        with pytest.raises(ValueError, match="mix state"):
            run_torch(name, gossip, resident=True)
        return
    host = run_torch(name, gossip)
    resident = run_torch(name, gossip, resident=True, kernel="fused")
    _same_run(host, resident)
    assert (resident.extras["transfers_h2d"],
            resident.extras["transfers_d2h"]) == (1, 1)


@pytest.mark.parametrize("name", ["loopless_dpsvrg", "dvr", "gt_svrg"])
def test_outer_transitions_folded_or_not_agree(name):
    """Coin-flip snapshots (and GT-SVRG's rounds) applied from the plan's
    per-step flags or as host ops between cut chunks give the same run."""
    folded = run_torch(name, "banded", resident=True,
                       device_transitions=True)
    other = run_torch(name, "banded", resident=True,
                      device_transitions=False)
    np.testing.assert_array_equal(other.history.epochs,
                                  folded.history.epochs)
    np.testing.assert_array_equal(other.history.objective,
                                  folded.history.objective)
    np.testing.assert_array_equal(other.params.numpy(),
                                  folded.params.numpy())


@pytest.mark.parametrize("name", ["loopless_dpsvrg", "dvr"])
def test_resident_matches_reference_resident(name):
    """Port resident against the reference's resident path on the banded
    transport, ledger included."""
    assert_histories_match(
        run_jax(name, "banded", resident=True, kernel="pallas"),
        run_torch(name, "banded", resident=True, kernel="fused"),
        device_gather=True)


@pytest.mark.parametrize("gossip", ["dense", "banded"])
@pytest.mark.parametrize("name", FUSED)
def test_fused_route_taken_and_equal_to_plain(name, gossip, monkeypatch):
    """A dense or banded phi reaches the fused step at every inner step (the
    buffer-level entry is called once a step: on a card, one launch), and
    the fused run equals the plain one to float tolerance."""
    plain = run_torch(name, gossip, resident=True, kernel="plain")
    calls = []
    orig = ops.fused_step_buf

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(ops, "fused_step_buf", counted)
    fused = run_torch(name, gossip, resident=True, kernel="fused")
    assert len(calls) == int(fused.history.steps[-1])
    _same_run(plain, fused)


def test_compressed_gossip_never_takes_the_fused_step(monkeypatch):
    monkeypatch.setattr(ops, "fused_step_buf", None)   # a call would fail
    run_torch("loopless_dpsvrg", "compressed", resident=True,
              kernel="fused")


def test_dvr_fused_folds_rho_into_the_mix_matrix():
    """rho = 1 is DPSVRG's full mix: DVR's fused step at rho 1 equals
    loopless DPSVRG's at one gossip round."""
    _, tp = problems()
    sched = tgraphs.b_connected_ring_schedule(M, 1)
    spec = TExecSpec(gossip="banded", device="cpu", resident=True,
                     kernel="fused")
    dvr = trunner.run(talgorithm.dvr_algorithm(tp, 0.2, 40, rho=1.0,
                                               snapshot_prob=0.1),
                      tp, sched, spec, record_every=10)
    ll = trunner.run(talgorithm.loopless_dpsvrg_algorithm(
        tp, 0.2, 40, snapshot_prob=0.1, consensus_rounds=1),
        tp, sched, spec, record_every=10)
    np.testing.assert_allclose(dvr.history.objective, ll.history.objective,
                               rtol=1e-6, atol=1e-7)


def test_dpsvrg_compress_bits_matches_reference():
    jp, tp = problems()
    hp = dict(alpha=0.2, beta=1.2, n0=4, num_outer=4, compress_bits=8)
    want = jrunner.run(jalgorithm.dpsvrg_algorithm(
        jp, jalgorithm.DPSVRGHyperParams(**hp)), jp,
        jgraphs.b_connected_ring_schedule(M, 2), JExecSpec(gossip="dense"),
        seed=0, record_every=5)
    for resident in (False, True):
        got = trunner.run(talgorithm.dpsvrg_algorithm(
            tp, talgorithm.DPSVRGHyperParams(**hp)), tp,
            tgraphs.b_connected_ring_schedule(M, 2),
            TExecSpec(gossip="dense", device="cpu", resident=resident),
            seed=0, record_every=5)
        for field in ("epochs", "comm_rounds", "steps"):
            np.testing.assert_array_equal(getattr(got.history, field),
                                          getattr(want.history, field))
        np.testing.assert_array_equal(got.extras["wire_bytes"],
                                      want.extras["wire_bytes"])
        np.testing.assert_allclose(got.history.objective,
                                   want.history.objective,
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


def test_conflicting_compression_raises():
    from repro_torch.core import transport
    _, tp = problems()
    algo = talgorithm.dpsvrg_algorithm(
        tp, talgorithm.DPSVRGHyperParams(compress_bits=8, num_outer=1))
    with pytest.raises(ValueError, match="conflicting compression"):
        trunner.run(algo, tp, tgraphs.b_connected_ring_schedule(M, 1),
                    TExecSpec(gossip=transport.CompressedBackend(bits=4),
                              device="cpu"))


def test_dspg_auto_picks_banded_on_the_ring_as_the_reference():
    from _torch_parity import build
    from repro_torch.core import transport
    jp, tp = problems()
    algo = build(talgorithm, "dspg", tp)
    sched = tgraphs.b_connected_ring_schedule(M, 1)
    assert transport.resolve_backend("auto", sched, algo.meta).name \
        == "banded"
    # both packages with ExecSpec's default gossip="auto"
    want = jrunner.run(build(jalgorithm, "dspg", jp), jp,
                       jgraphs.b_connected_ring_schedule(M, 1),
                       JExecSpec(resident=True, kernel="pallas"), seed=0,
                       record_every=10)
    for kernel in ("plain", "fused"):
        got = trunner.run(build(talgorithm, "dspg", tp), tp, sched,
                          TExecSpec(device="cpu", resident=True,
                                    kernel=kernel), seed=0, record_every=10)
        assert_histories_match(want, got, device_gather=True)
