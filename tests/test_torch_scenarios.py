"""The port's network-event scenarios (``repro_torch.scenarios``: models and
transports) against the JAX package's ``repro.scenarios``, on the CPU.

The same numpy inputs go through both packages:

* realized mixing matrices of ``LinkFailures``, ``NodeChurn`` and both
  composed, over 200 slots and three seeds, and ``graphs.metropolis_
  weights``: bitwise (host numpy on both sides);
* the zero-intensity identity, bitwise, for every registered algorithm on
  the host loop and the resident path: a scenario-wrapped run at zero
  intensity is the unwrapped run;
* the staleness pipeline: at zero intensity bitwise the inner mix; its
  FIFO semantics; straggler masks (bitwise the reference's, a fresh draw
  per slot); a few mixes against the reference's ``scenario_mix`` within
  rtol 1e-6 / atol 1e-7 (one float32 mix of the same inputs);
* stale and straggler histories of loopless DPSVRG and GT-SVRG against the
  reference's host loop, on the port's host loop and resident path:
  objective and consensus within rtol 1e-4 / atol 1e-6, wire bytes exactly;
* the refusals (``dspg``/``dpg`` under a stateful scenario, the
  ``meta.compress_bits`` conflict, nesting) and the failure-aware
  accounting, whose integers equal the reference's;
* the link-failure / churn scenario through ``kernel="fused"`` (on the CPU
  the fused step's plain version) against the reference's
  ``kernel="pallas"`` (interpret mode), a churned-out node's row of the
  staged mixing matrix (``e_i``) checked where the cell-batched launch
  receives it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jsc
from repro.core import algorithm as jalgorithm, compression as jcompression, \
    graphs as jgraphs, prox as jprox, runner as jrunner, \
    transport as jtransport
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro.data import synthetic as jsynthetic
from repro.scenarios import transports as jsc_transports
from repro_torch import scenarios as tsc
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm as talgorithm, \
    compression as tcompression, gossip as tgossip, graphs as tgraphs, \
    prox as tprox, runner as trunner, sweep as tsweep, \
    transport as ttransport
from repro_torch.core.exec_spec import ExecSpec as TExecSpec
from repro_torch.kernels.fused_update import ops as fused_ops
from repro_torch.scenarios import transports as tsc_transports

torch.set_num_threads(1)

M, N, D = 4, 128, 12
# whole runs of both packages: the same float32 arithmetic summed in other
# orders (XLA vs ATen), compounded over the run
HISTORY_TOL = dict(rtol=1e-4, atol=1e-6)
# one mix of the same float32 inputs in each framework
MIX_TOL = dict(rtol=1e-6, atol=1e-7)


def jax_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return jnp.mean(-y * logits + jnp.log1p(jnp.exp(logits)))


def torch_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))


@functools.lru_cache(maxsize=None)
def _parts(m=M):
    ds = jsynthetic.make_classification(n=N, d=D, seed=0)
    return jsynthetic.partition_per_node(ds, m)


def _problems(m=M):
    """(jax Problem, port Problem) on the same partitioned data."""
    parts = _parts(m)
    x0 = np.zeros((m, D), np.float32)
    jp = jalgorithm.Problem(jax_loss, jprox.l1(0.01), jnp.asarray(x0),
                            {k: jnp.asarray(v) for k, v in parts.items()})
    tp = talgorithm.Problem(torch_loss, tprox.l1(0.01),
                            params_from_numpy(x0, "cpu"),
                            params_from_numpy(parts, "cpu"))
    return jp, tp


def _ring(pkg, m=M):
    return pkg.static_schedule(pkg.ring_matrix(m), name=f"ring{m}")


def _factory(pkg, name, problem):
    """Short runs of every registered multi-node algorithm (the
    reference's test_scenarios factory)."""
    if name == "dpsvrg":
        return pkg.dpsvrg_algorithm(
            problem, pkg.DPSVRGHyperParams(alpha=0.3, beta=1.2, n0=3,
                                           num_outer=3))
    if name == "dspg":
        return pkg.dspg_algorithm(problem, pkg.DSPGHyperParams(alpha0=0.3),
                                  20)
    if name == "dpg":
        return pkg.dpg_algorithm(problem, 0.3, 10)
    if name == "gt_svrg":
        return pkg.gt_svrg_algorithm(problem, 0.1, 2, 8)
    if name == "loopless_dpsvrg":
        return pkg.loopless_dpsvrg_algorithm(problem, 0.3, 20,
                                             snapshot_prob=0.25)
    if name == "dvr":
        return pkg.dvr_algorithm(problem, 0.3, 20, rho=0.7,
                                 snapshot_prob=0.25)
    raise KeyError(name)


def _port_models(models):
    """The port's twins of reference scenario models."""
    return [getattr(tsc, type(mdl).__name__)(**vars(mdl)) for mdl in models]


def test_package_exports_the_reference_names():
    assert tsc.__all__ == jsc.__all__
    for name in tsc.__all__:
        assert hasattr(tsc, name), name


# ---------------------------------------------------------------------------
# Schedule-level models: realized matrices bitwise the reference's
# ---------------------------------------------------------------------------

MODEL_SETS = {
    "links": [jsc.LinkFailures(0.4)],
    "churn": [jsc.NodeChurn(0.3, dwell=4)],
    "both": [jsc.LinkFailures(0.3), jsc.NodeChurn(0.2, dwell=5)],
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("models", sorted(MODEL_SETS))
def test_realized_matrices_equal_reference_bitwise(models, seed):
    jbase = jgraphs.b_connected_ring_schedule(8, b=2, seed=1)
    tbase = tgraphs.b_connected_ring_schedule(8, b=2, seed=1)
    jsched = jsc.wrap_schedule(jbase, MODEL_SETS[models], seed=seed)
    tsched = tsc.wrap_schedule(tbase, _port_models(MODEL_SETS[models]),
                               seed=seed)
    assert tsched.name == jsched.name
    assert tsched.aperiodic and tsched.structure_schedule is tbase
    degraded = 0
    for t in range(200):
        want, got = jsched.matrix(t), tsched.matrix(t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"slot {t}")
        # a slot without events is the base matrix object itself
        assert (got is tbase.matrix(t)) == (want is jbase.matrix(t))
        degraded += got is not tbase.matrix(t)
    assert degraded > 0


def test_metropolis_weights_equal_reference_bitwise():
    rng = np.random.default_rng(5)
    for m in (2, 5, 8, 13):
        for _ in range(20):
            upper = np.triu(rng.random((m, m)) < 0.4, 1)
            adj = upper | upper.T
            np.testing.assert_array_equal(tgraphs.metropolis_weights(adj),
                                          jgraphs.metropolis_weights(adj))


def test_zero_intensity_apply_is_passthrough():
    ring = _ring(tgraphs)
    sched, backend = tsc.apply(
        ring, [tsc.LinkFailures(0.0), tsc.NodeChurn(0.0),
               tsc.StaleGossip(0), tsc.Stragglers(1.0)], gossip="dense")
    assert sched is ring
    assert backend == "dense"


def test_realized_matrices_doubly_stochastic_support_subset():
    base = tgraphs.b_connected_ring_schedule(8, b=2, seed=1)
    sched = tsc.wrap_schedule(base, [tsc.LinkFailures(0.4),
                                     tsc.NodeChurn(0.2)], seed=3)
    off = ~np.eye(8, dtype=bool)
    for t in range(20):
        w = sched.matrix(t)
        np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-12)
        np.testing.assert_allclose(w.sum(1), 1.0, atol=1e-12)
        np.testing.assert_array_equal(w, w.T)
        base_support = np.abs(base.matrix(t)) > 1e-12
        assert np.all((np.abs(w) > 1e-12)[off] <= base_support[off])


def test_event_draws_deterministic_and_seed_sensitive():
    base = _ring(tgraphs, 6)
    a = tsc.wrap_schedule(base, [tsc.LinkFailures(0.4)], seed=9)
    b = tsc.wrap_schedule(base, [tsc.LinkFailures(0.4)], seed=9)
    c = tsc.wrap_schedule(base, [tsc.LinkFailures(0.4)], seed=10)
    mats_a = [a.matrix(t) for t in range(25)]
    assert all(np.array_equal(m, b.matrix(t)) for t, m in enumerate(mats_a))
    d = tsc.wrap_schedule(base, [tsc.LinkFailures(0.4)], seed=9)
    assert all(np.array_equal(d.matrix(t), mats_a[t])
               for t in reversed(range(25)))
    assert any(not np.array_equal(c.matrix(t), mats_a[t])
               for t in range(25))


def test_churn_isolates_down_nodes_for_whole_dwell_window():
    base = _ring(tgraphs, 6)
    sched = tsc.wrap_schedule(base, [tsc.NodeChurn(0.5, dwell=4)], seed=2)
    found = False
    for window in range(10):
        t0 = window * 4
        w0 = sched.matrix(t0)
        down = [i for i in range(6)
                if w0[i, i] == 1.0 and np.all(np.delete(w0[i], i) == 0)]
        if not down:
            continue
        found = True
        for t in range(t0, t0 + 4):
            w = sched.matrix(t)
            for i in down:
                np.testing.assert_array_equal(w[i], np.eye(6)[i])
                np.testing.assert_array_equal(w[:, i], np.eye(6)[i])
    assert found


def test_wrapper_composition_errors():
    ring = _ring(tgraphs)
    wrapped = tsc.wrap_schedule(ring, [tsc.LinkFailures(0.2)])
    with pytest.raises(ValueError, match="already scenario-wrapped"):
        tsc.wrap_schedule(wrapped, [tsc.NodeChurn(0.2)])
    with pytest.raises(ValueError, match="at most one LinkFailures"):
        tsc.wrap_schedule(ring, [tsc.LinkFailures(0.2),
                                 tsc.LinkFailures(0.3)])
    with pytest.raises(TypeError, match="unknown scenario model"):
        tsc.apply(ring, ["links"])
    with pytest.raises(ValueError, match="do not nest"):
        tsc.apply(ring, [tsc.StaleGossip(1)],
                  gossip=tsc_transports.ScenarioBackend())
    with pytest.raises(ValueError, match="compress_bits"):
        tsc_transports.ScenarioBackend(inner="compressed")
    # over ppermute the pipeline needs a process group of m ranks
    # (tests/test_torch_mesh.py); without one, preparing it says how
    with pytest.raises(ValueError, match="spmd.spawn"):
        tsc_transports.ScenarioBackend(inner="ppermute").prepare(ring, None)


def test_structure_schedule_exposes_base_for_band_unions():
    base = _ring(tgraphs, 6)
    sched = tsc.wrap_schedule(base, [tsc.LinkFailures(0.5)], seed=1)
    meta = ttransport.TransportMeta.constant(1)
    assert (ttransport.band_offset_union(sched, meta)
            == ttransport.band_offset_union(base, meta))


# ---------------------------------------------------------------------------
# Zero-intensity identity: wrapped == unwrapped, bit for bit
# ---------------------------------------------------------------------------

def _zero_wrapped(ring):
    """A ScenarioSchedule + ScenarioBackend pair that is all machinery at
    zero intensity: every realized matrix is the base object, the transport
    the pure accounting wrapper."""
    sched = tsc.ScenarioSchedule(
        matrices=ring.matrices, b=ring.b, eta=ring.eta, name=ring.name,
        base=ring, link_p=0.0, churn_p=0.0, seed=0)
    return sched, tsc_transports.ScenarioBackend(inner="dense")


@pytest.mark.parametrize("path", ["host", "resident"])
@pytest.mark.parametrize("name", sorted(talgorithm.ALGORITHMS))
def test_zero_intensity_identity_bitwise(name, path):
    _, problem = _problems()
    if name == "inexact_prox_svrg":
        from repro_torch.core import inexact
        data = {k: v.reshape(1, -1, *v.shape[2:])
                for k, v in problem.full_data.items()}
        problem = talgorithm.Problem(torch_loss, problem.prox,
                                     torch.zeros(1, D), data)
        ring = tgraphs.static_schedule(np.eye(1), name="centralized")

        def build(p):
            return talgorithm.ALGORITHMS[name](
                p, inexact.InexactHyperParams(alpha=0.3, beta=1.2, n0=3,
                                              num_outer=2))
    else:
        ring = _ring(tgraphs)
        build = functools.partial(_factory, talgorithm, name)
    sched, backend = _zero_wrapped(ring)
    spec = TExecSpec(resident=path == "resident", device="cpu")
    kw = dict(seed=4, record_every=5)
    base = trunner.run(build(problem), problem, ring,
                       spec.replace(gossip="dense"), **kw)
    wrapped = trunner.run(build(problem), problem, sched,
                          spec.replace(gossip=backend), **kw)
    for field in trunner.RunHistory._fields:
        np.testing.assert_array_equal(getattr(base.history, field),
                                      getattr(wrapped.history, field),
                                      err_msg=f"{name}/{path}/{field}")
    np.testing.assert_array_equal(base.params.numpy(),
                                  wrapped.params.numpy())


# ---------------------------------------------------------------------------
# The staleness pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ["dense", "banded"])
def test_staleness_pipeline_zero_intensity_is_inner_mix_bitwise(inner):
    """An all-fresh mask and no delay reproduce the inner mix exactly (the
    correction term is a multiply-by-zero)."""
    m, d = 5, 3
    w = tgraphs.ring_matrix(m)
    phi = (torch.as_tensor(w, dtype=torch.float32) if inner == "dense"
           else tgossip.BandedPhi.from_dense(w, (0, 1, m - 1)))
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(m, d)),
                        dtype=torch.float32)
    sphi = tsc_transports.ScenarioPhi(phi, torch.ones(m), 0)
    state = tsc_transports.ScenarioMixState(None, torch.zeros_like(x), None)
    out, _ = tsc_transports.scenario_mix(sphi, x, state)
    np.testing.assert_array_equal(out.numpy(),
                                  tgossip.mix_stacked(phi, x).numpy())


def test_delay_buffer_fifo_semantics():
    m = 4
    ring = _ring(tgraphs, m)
    backend = tsc_transports.ScenarioBackend(inner="dense", delay=1)
    aux = backend.prepare(ring, None)
    phi = backend.phi_for(aux, 0, 1)
    state = backend.init_mix_state(aux, torch.zeros(m, 2))
    w = ring.matrix(0)
    x1 = torch.arange(8.0).reshape(m, 2)
    out1, state = tcompression.mix_with_state(phi, x1, state)
    # the first mix sees the pre-filled x0 buffer: only the self term moves
    np.testing.assert_allclose(out1.numpy(), np.diag(w)[:, None] * x1.numpy(),
                               rtol=1e-6)
    x2 = x1 + 100.0
    out2, state = backend.mix(aux, phi, x2, state)
    np.testing.assert_allclose(
        out2.numpy(),
        w @ x1.numpy() + np.diag(w)[:, None] * (x2 - x1).numpy(), rtol=1e-6)
    # the FIFO now holds x2, the next mix's transmitted payload
    np.testing.assert_array_equal(state.buffer[0].numpy(), x2.numpy())


def test_straggler_masks_vary_per_slot_and_equal_the_reference():
    jb = jsc_transports.ScenarioBackend(inner="dense", straggler_p=0.5,
                                        seed=3)
    tb = tsc_transports.ScenarioBackend(inner="dense", straggler_p=0.5,
                                        seed=3)
    jsched = jsc.wrap_schedule(_ring(jgraphs, 8), [jsc.LinkFailures(0.2)],
                               seed=4)
    tsched = tsc.wrap_schedule(_ring(tgraphs, 8), [tsc.LinkFailures(0.2)],
                               seed=4)
    ja, ta = jb.prepare(jsched, None, mesh=None), tb.prepare(tsched, None)
    masks = []
    for t in range(16):
        want, got = jb.phi_for(ja, t, 1), tb.phi_for(ta, t, 1)
        np.testing.assert_array_equal(got.mask, want.mask)
        np.testing.assert_array_equal(got.inner, np.asarray(want.inner))
        masks.append(got.mask)
    assert any(not np.array_equal(masks[0], mk) for mk in masks[1:])
    # same slot -> the same cached object
    assert tb.phi_for(ta, 3, 1) is tb.phi_for(ta, 3, 1)


@pytest.mark.parametrize("bits", [None, 8])
def test_scenario_mix_matches_reference(bits):
    """Delay 2 and a straggler mask, over a quantized inner transport or
    not: a few mixes of the same inputs agree with the reference's."""
    m, d = 6, 5
    rng = np.random.default_rng(1)
    kw = dict(inner="dense", delay=2, straggler_p=0.4, seed=2,
              compress_bits=bits)
    jb = jsc_transports.ScenarioBackend(**kw)
    tb = tsc_transports.ScenarioBackend(**kw)
    js, ts = (jgraphs.b_connected_ring_schedule(m, 2, seed=0),
              tgraphs.b_connected_ring_schedule(m, 2, seed=0))
    ja, ta = jb.prepare(js, None, mesh=None), tb.prepare(ts, None)
    x0 = rng.normal(size=(m, d)).astype(np.float32)
    jstate = jb.init_mix_state(ja, jnp.asarray(x0))
    tstate = tb.init_mix_state(ta, torch.from_numpy(x0))
    for t in range(6):
        x = rng.normal(size=(m, d)).astype(np.float32)
        jphi, tphi = jb.phi_for(ja, t, 1), tb.phi_for(ta, t, 1)
        tphi = ttransport.pytree.tree_map(
            lambda a: None if a is None else torch.as_tensor(a), tphi)
        jout, jstate = jcompression.mix_with_state(jphi, jnp.asarray(x),
                                                   jstate)
        tout, tstate = tcompression.mix_with_state(tphi, torch.from_numpy(x),
                                                   tstate)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   **MIX_TOL, err_msg=f"step {t}")
        np.testing.assert_allclose(tstate.buffer.numpy(),
                                   np.asarray(jstate.buffer), **MIX_TOL)
        np.testing.assert_allclose(tstate.sent.numpy(),
                                   np.asarray(jstate.sent), **MIX_TOL)


@pytest.mark.parametrize("path", ["host", "resident", "scan"])
@pytest.mark.parametrize("name", ["loopless_dpsvrg", "gt_svrg"])
def test_stale_straggler_histories_match_reference(name, path):
    """Delay + straggler gossip through the algorithm's mix-state slot
    (gt_svrg threads a pair of states), the port's host loop, resident
    path and scan path against the reference's host loop."""
    jp, tp = _problems()
    models = [jsc.StaleGossip(2), jsc.Stragglers(2.0)]
    jsched, jb = jsc.apply(_ring(jgraphs), models, seed=6)
    tsched, tb = tsc.apply(_ring(tgraphs), _port_models(models), seed=6)
    want = jrunner.run(_factory(jalgorithm, name, jp), jp, jsched,
                       JExecSpec(gossip=jb), seed=2, record_every=5)
    got = trunner.run(_factory(talgorithm, name, tp), tp, tsched,
                      TExecSpec(gossip=tb, device="cpu",
                                resident=path == "resident",
                                scan=path == "scan"),
                      seed=2, record_every=5)
    for field in ("steps", "epochs", "comm_rounds"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      np.asarray(getattr(want.history,
                                                         field)))
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  np.asarray(want.extras["wire_bytes"]))
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(got.history, col),
                                   np.asarray(getattr(want.history, col)),
                                   **HISTORY_TOL, err_msg=col)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               **HISTORY_TOL)


def test_stale_gossip_still_converges():
    _, tp = _problems()
    sched, backend = tsc.apply(
        _ring(tgraphs), [tsc.StaleGossip(2), tsc.Stragglers(2.0)], seed=1)
    res = trunner.run(
        talgorithm.loopless_dpsvrg_algorithm(tp, 0.3, 120,
                                             snapshot_prob=0.1),
        tp, sched, TExecSpec(resident=True, gossip=backend, device="cpu"),
        seed=0, record_every=30)
    obj = res.history.objective
    assert obj[-1] < obj[0] - 0.05


@pytest.mark.parametrize("name", ["dspg", "dpg"])
def test_stateless_algorithms_refused_by_stateful_scenario(name):
    _, tp = _problems()
    sched, backend = tsc.apply(_ring(tgraphs), [tsc.StaleGossip(1)])
    with pytest.raises(ValueError, match="init_mix_state"):
        trunner.run(_factory(talgorithm, name, tp), tp, sched,
                    TExecSpec(gossip=backend, device="cpu"))
    # a scenario phi reaching their stateless mix is refused by type
    phi = tsc_transports.ScenarioPhi(
        torch.as_tensor(tgraphs.ring_matrix(M), dtype=torch.float32), None,
        1)
    algo = _factory(talgorithm, name, tp)
    with pytest.raises(TypeError, match="stateful"):
        tgossip.mix_stacked(phi, tp.x0)
    with pytest.raises(TypeError, match="stateful"):
        algo.step(algo.init(), {k: v[:, :1] for k, v in tp.full_data.items()},
                  phi, 0.1)
    assert ttransport.mix_matrix(phi) is None


def test_meta_compress_bits_refused_under_scenario_transport():
    _, tp = _problems()
    algo = talgorithm.dpsvrg_algorithm(
        tp, talgorithm.DPSVRGHyperParams(alpha=0.3, beta=1.2, n0=3,
                                         num_outer=2, compress_bits=8))
    sched, backend = tsc.apply(_ring(tgraphs), [tsc.StaleGossip(1)])
    with pytest.raises(ValueError, match="compress_bits"):
        trunner.run(algo, tp, sched, TExecSpec(gossip=backend, device="cpu"))


def test_quantized_scenario_transport_runs_and_charges_less():
    _, tp = _problems()
    out = {}
    for bits in (8, None):
        sched, backend = tsc.apply(_ring(tgraphs), [tsc.StaleGossip(1)],
                                   compress_bits=bits, seed=1)
        out[bits] = trunner.run(
            talgorithm.loopless_dpsvrg_algorithm(tp, 0.3, 30,
                                                 snapshot_prob=0.1),
            tp, sched, TExecSpec(resident=True, gossip=backend,
                                 device="cpu"), seed=0, record_every=10)
    assert out[8].extras["wire_bytes"][-1] * 4 == \
        out[None].extras["wire_bytes"][-1]
    assert out[8].history.objective[-1] < 0.69


# ---------------------------------------------------------------------------
# Failure-aware wire accounting: the reference's integers
# ---------------------------------------------------------------------------

def test_dropped_links_not_charged_and_equal_reference():
    jsched = jsc.wrap_schedule(_ring(jgraphs, 8), [jsc.LinkFailures(0.5)],
                               seed=0)
    tsched = tsc.wrap_schedule(_ring(tgraphs, 8), [tsc.LinkFailures(0.5)],
                               seed=0)
    jb = jsc_transports.ScenarioBackend(inner="dense")
    tb = tsc_transports.ScenarioBackend(inner="dense")
    ja, ta = jb.prepare(jsched, None, mesh=None), tb.prepare(tsched, None)
    full = tb.bytes_per_step(ta, tgraphs.ring_matrix(8), 12)
    cheaper = False
    for t in range(30):
        w = tsched.matrix(t)
        links = {(j, i) for i in range(8) for j in range(8)
                 if i != j and abs(w[i, j]) > 1e-12}
        per_link = tb.bytes_per_link(ta, torch.as_tensor(w), 12)
        total = tb.bytes_per_step(ta, w, 12)
        assert set(per_link) == links
        assert sum(per_link.values()) == total == len(links) * 12 * 4
        assert per_link == jb.bytes_per_link(ja, jsched.matrix(t), 12)
        assert total == jb.bytes_per_step(ja, jsched.matrix(t), 12)
        cheaper |= total < full
    assert cheaper


def test_per_link_maps_sum_exactly_under_quantization():
    jb = jsc_transports.ScenarioBackend(inner="dense")
    tb = tsc_transports.ScenarioBackend(inner="dense")
    ja = jb.prepare(_ring(jgraphs, 6), None, mesh=None)
    ta = tb.prepare(_ring(tgraphs, 6), None)
    w = tgraphs.ring_matrix(6)
    for bits, count in [(8, 3), (12, 3), (6, 5), (4, 7)]:
        tphi = tcompression.CompressedPhi(w, bits)
        jphi = jcompression.CompressedPhi(jnp.asarray(w, jnp.float32), bits)
        per_link = tb.bytes_per_link(ta, tphi, count)
        total = tb.bytes_per_step(ta, tphi, count)
        assert sum(per_link.values()) == total
        assert total == (12 * count * 4) * bits // 32
        assert per_link == jb.bytes_per_link(ja, jphi, count)
        assert total == jb.bytes_per_step(ja, jphi, count)


def test_banded_inner_accounting_matches_realized_entries_and_reference():
    m = 6
    jsched = jgraphs.MixingSchedule(tuple(jgraphs.edge_matching_matrices(m)),
                                    b=m - 1, eta=0.5, name="matchings")
    tsched = tgraphs.MixingSchedule(tuple(tgraphs.edge_matching_matrices(m)),
                                    b=m - 1, eta=0.5, name="matchings")
    meta_j = jtransport.TransportMeta.constant(1)
    meta_t = ttransport.TransportMeta.constant(1)
    for kw in (dict(), dict(delay=1), dict(compress_bits=8)):
        jb = jsc_transports.ScenarioBackend(inner="banded", **kw)
        tb = tsc_transports.ScenarioBackend(inner="banded", **kw)
        ja, ta = jb.prepare(jsched, meta_j, mesh=None), tb.prepare(tsched,
                                                                   meta_t)
        for slot in range(2 * m):
            jphi, tphi = jb.phi_for(ja, slot, 1), tb.phi_for(ta, slot, 1)
            per_link = tb.bytes_per_link(ta, tphi, 4)
            w = tsched.matrix(slot)
            assert set(per_link) == {(j, i) for i in range(m)
                                     for j in range(m)
                                     if i != j and abs(w[i, j]) > 1e-12}
            assert sum(per_link.values()) == tb.bytes_per_step(ta, tphi, 4)
            assert per_link == jb.bytes_per_link(ja, jphi, 4)
            assert tb.bytes_per_step(ta, tphi, 4) == \
                jb.bytes_per_step(ja, jphi, 4)


def test_phi_diag_of_every_wire_format():
    w = tgraphs.b_connected_ring_schedule(6, 2, seed=0).consensus_rounds(0,
                                                                          2)
    like = torch.zeros(6, 3)
    want = np.diag(w).astype(np.float32)
    banded = tgossip.BandedPhi.from_dense(w, tgossip.band_decompose(w)[0])
    no_self = tgossip.BandedPhi((1, 5), np.ones((2, 6), np.float32))
    for phi in (w, torch.as_tensor(w, dtype=torch.float32), banded,
                tcompression.CompressedPhi(banded, 8)):
        got = tsc_transports._phi_diag(phi, like)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tsc_transports._phi_diag(no_self, like).numpy(), np.zeros(6))


# ---------------------------------------------------------------------------
# Link failures and churn through the fused step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dpsvrg", "loopless_dpsvrg", "dspg"])
def test_link_failure_scenario_fused_matches_reference_pallas(name,
                                                              monkeypatch):
    """A schedule-level scenario leaves the wire stateless: the accounting
    wrapper hands the realized dense W^t to the fused step at every inner
    step (the port's plain version on the CPU; the reference's Pallas
    kernel in interpret mode)."""
    jp, tp = _problems()
    models = [jsc.LinkFailures(0.3), jsc.NodeChurn(0.2, dwell=5)]
    jsched, jb = jsc.apply(jgraphs.b_connected_ring_schedule(M, 1), models,
                           seed=3)
    tsched, tb = tsc.apply(tgraphs.b_connected_ring_schedule(M, 1),
                           _port_models(models), seed=3)
    want = jrunner.run(_factory(jalgorithm, name, jp), jp, jsched,
                       JExecSpec(resident=True, kernel="pallas", gossip=jb),
                       seed=1, record_every=5)
    calls = []
    orig = fused_ops.fused_step_buf

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(fused_ops, "fused_step_buf", counted)
    got = trunner.run(_factory(talgorithm, name, tp), tp, tsched,
                      TExecSpec(resident=True, kernel="fused", gossip=tb,
                                device="cpu"), seed=1, record_every=5)
    assert len(calls) == int(got.history.steps[-1])
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  np.asarray(want.extras["wire_bytes"]))
    np.testing.assert_array_equal(got.history.epochs,
                                  np.asarray(want.history.epochs))
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(got.history, col),
                                   np.asarray(getattr(want.history, col)),
                                   **HISTORY_TOL, err_msg=col)


def test_churned_node_row_reaches_the_cell_batched_launch(monkeypatch):
    """A batched sweep over degraded schedules stages one W^t a cell a step:
    the cell-batched launch receives each cell's realized matrix, a
    churned-out node's row and column as e_i."""
    _, tp = _problems(8)
    base = tgraphs.b_connected_ring_schedule(8, 1)
    scheds = [tsc.wrap_schedule(base, [tsc.NodeChurn(0.4, dwell=3)],
                                seed=s) for s in (0, 1, 2)]
    backend = tsc_transports.ScenarioBackend(inner="dense")
    seen = []
    orig = fused_ops.fused_step_cells_buf

    def spy(w, *args, **kw):
        seen.append(w.clone())
        return orig(w, *args, **kw)

    monkeypatch.setattr(fused_ops, "fused_step_cells_buf", spy)
    steps = 12
    res = tsweep.run_sweep(
        lambda: (talgorithm.dspg_algorithm(
            tp, talgorithm.DSPGHyperParams(alpha0=0.3), steps), tp),
        {"schedule": scheds},
        TExecSpec(resident=True, kernel="fused", gossip=backend,
                  device="cpu"), record_every=4)
    assert len(seen) == steps
    isolated = 0
    for t, w in enumerate(seen):
        assert w.shape == (3, 8, 8)
        for c, sched in enumerate(scheds):
            want = sched.matrix(1 + t)          # DSPG gossips from slot 1
            np.testing.assert_array_equal(w[c].numpy(),
                                          want.astype(np.float32))
            for i in range(8):
                if want[i, i] == 1.0:
                    np.testing.assert_array_equal(w[c, i].numpy(),
                                                  np.eye(8)[i])
                    isolated += 1
    assert isolated > 0
    plain = tsweep.run_sweep(
        lambda: (talgorithm.dspg_algorithm(
            tp, talgorithm.DSPGHyperParams(alpha0=0.3), steps), tp),
        {"schedule": scheds},
        TExecSpec(resident=True, kernel="plain", gossip=backend,
                  device="cpu"), record_every=4)
    np.testing.assert_allclose(res.history.objective,
                               plain.history.objective, **HISTORY_TOL)
    np.testing.assert_array_equal(res.extras["wire_bytes"],
                                  plain.extras["wire_bytes"])
