"""Parity of the port's host-side modules with the JAX package: graphs,
schedules, synthetic data and the paper's config are numpy copies and must
agree BITWISE; the execution spec and the transport's "auto" rule keep the
reference's semantics under the port's own names."""

import dataclasses

import numpy as np
import pytest

from repro.configs import paper_logreg as jconfig
from repro.core import algorithm as jalgorithm, graphs as jgraphs, \
    schedules as jschedules, transport as jtransport
from repro.data import synthetic as jsynthetic
from repro_torch.configs import paper_logreg as tconfig
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    schedules as tschedules, transport as ttransport
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic as tsynthetic


def _assert_schedules_equal(a, b):
    assert (a.b, a.eta, a.name, a.period) == (b.b, b.eta, b.name, b.period)
    for wa, wb in zip(a.matrices, b.matrices):
        np.testing.assert_array_equal(wa, wb)
    for t0 in range(2 * a.period):
        for rounds in (0, 1, 3, 7):
            np.testing.assert_array_equal(a.consensus_rounds(t0, rounds),
                                          b.consensus_rounds(t0, rounds))
    assert jgraphs.lemma1_constants(a) == tgraphs.lemma1_constants(b)


@pytest.mark.parametrize("m,b,seed", [(8, 1, 0), (8, 2, 0), (8, 3, 5),
                                      (5, 2, 1), (12, 4, 7)])
def test_b_connected_ring_schedule_bitwise(m, b, seed):
    _assert_schedules_equal(jgraphs.b_connected_ring_schedule(m, b, seed),
                            tgraphs.b_connected_ring_schedule(m, b, seed))


@pytest.mark.parametrize("m,b", [(8, 3), (6, 2)])
def test_random_b_connected_schedule_bitwise(m, b):
    _assert_schedules_equal(
        jgraphs.random_b_connected_schedule(m, b, p_keep=0.4, seed=3),
        tgraphs.random_b_connected_schedule(m, b, p_keep=0.4, seed=3))


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_graph_constructors_bitwise(m):
    rng = np.random.default_rng(m)
    adj = rng.random((m, m)) < 0.5
    adj = adj | adj.T
    np.testing.assert_array_equal(jgraphs.metropolis_weights(adj),
                                  tgraphs.metropolis_weights(adj))
    np.testing.assert_array_equal(jgraphs.ring_matrix(m),
                                  tgraphs.ring_matrix(m))
    np.testing.assert_array_equal(jgraphs.fully_connected_matrix(m),
                                  tgraphs.fully_connected_matrix(m))
    for fam in ("exponential_graph_matrices", "edge_matching_matrices"):
        for wa, wb in zip(getattr(jgraphs, fam)(m), getattr(tgraphs, fam)(m)):
            np.testing.assert_array_equal(wa, wb)
    w = tgraphs.ring_matrix(m)
    assert jgraphs.spectral_gap(w) == tgraphs.spectral_gap(w)
    assert jgraphs.is_doubly_stochastic(w) == tgraphs.is_doubly_stochastic(w)
    mats = [tgraphs.ring_matrix(m), tgraphs.fully_connected_matrix(m)]
    np.testing.assert_array_equal(jgraphs.phi_product(mats),
                                  tgraphs.phi_product(mats))
    x = rng.normal(size=(m, 7)).astype(np.float32)
    assert jgraphs.consensus_distance(x) == tgraphs.consensus_distance(x)


def test_schedules_bitwise():
    for args in [(1.07, 8, 30), (1.2, 4, 10), (2.0, 1, 5)]:
        assert (jschedules.inner_loop_lengths(*args)
                == tschedules.inner_loop_lengths(*args))
        assert (jschedules.total_inner_steps(*args)
                == tschedules.total_inner_steps(*args))
    pairs = [
        (jschedules.dspg_stepsize(0.2, 0.5), tschedules.dspg_stepsize(0.2, 0.5)),
        (jschedules.constant(0.01), tschedules.constant(0.01)),
        (jschedules.cosine(0.1, 100), tschedules.cosine(0.1, 100)),
        (jschedules.warmup_cosine(0.1, 10, 100),
         tschedules.warmup_cosine(0.1, 10, 100)),
        (jschedules.wsd(0.1, 10, 50, 40), tschedules.wsd(0.1, 10, 50, 40)),
    ]
    for fj, ft in pairs:
        assert [fj(k) for k in range(120)] == [ft(k) for k in range(120)]


@pytest.mark.parametrize("key", sorted(jsynthetic.PAPER_DATASETS))
def test_paper_dataset_and_partition_bitwise(key):
    dj = jsynthetic.make_paper_dataset(key, scale=0.01, seed=3)
    dt = tsynthetic.make_paper_dataset(key, scale=0.01, seed=3)
    assert (dj.name, dj.n, dj.dim) == (dt.name, dt.n, dt.dim)
    np.testing.assert_array_equal(dj.features, dt.features)
    np.testing.assert_array_equal(dj.labels, dt.labels)
    for het in (0.0, 0.5):
        pj = jsynthetic.partition_per_node(dj, 8, heterogeneity=het, seed=1)
        pt = tsynthetic.partition_per_node(dt, 8, heterogeneity=het, seed=1)
        for k in ("features", "labels"):
            np.testing.assert_array_equal(pj[k], pt[k])


def test_token_stream_bitwise():
    sj = jsynthetic.make_token_stream(2000, 64, seed=2)
    st = tsynthetic.make_token_stream(2000, 64, seed=2)
    np.testing.assert_array_equal(sj.tokens, st.tokens)
    bj, bt = sj.batches(3, 16, seed=4), st.batches(3, 16, seed=4)
    for _ in range(3):
        for a, b in zip(next(bj), next(bt)):
            np.testing.assert_array_equal(a, b)


def test_paper_logreg_config_equal():
    assert (dataclasses.asdict(jconfig.CONFIG)
            == dataclasses.asdict(tconfig.CONFIG))


# ---------------------------------------------------------------------------
# ExecSpec: the port's kernel names, device, and refusals
# ---------------------------------------------------------------------------

def test_exec_spec_defaults_and_kernel_names():
    spec = ExecSpec()
    assert (spec.resident, spec.kernel, spec.gossip, spec.device) == (
        False, "plain", "auto", "cuda")
    for kernel in ("plain", "fused", "auto"):
        assert ExecSpec(resident=True, kernel=kernel).kernel == kernel
    for bad in ("xla", "pallas", "triton"):
        with pytest.raises(ValueError, match="kernel must be"):
            ExecSpec(resident=True, kernel=bad)


@pytest.mark.parametrize("kw,err", [
    (dict(kernel="fused"), ValueError),
    (dict(sampling="device"), ValueError),
    (dict(device_transitions=True), ValueError),
    (dict(sampling="nowhere", resident=True), ValueError),
    (dict(device_transitions="sometimes", resident=True), ValueError),
    (dict(device="not-a-device"), RuntimeError),
    (dict(shard="nodes"), ValueError),
    (dict(resident=True, shard="rows"), ValueError),
])
def test_exec_spec_rejects(kw, err):
    with pytest.raises(err):
        ExecSpec(**kw)


def test_exec_spec_replace_revalidates():
    spec = ExecSpec(resident=True, kernel="fused", device="cpu")
    assert spec.replace(kernel="auto").kernel == "auto"
    with pytest.raises(ValueError):
        spec.replace(resident=False)


# ---------------------------------------------------------------------------
# transport: the dense backend and the reference's "auto" rule
# ---------------------------------------------------------------------------

def _metas(jpkg, tpkg):
    """Transport-relevant metas of DPSVRG (multi-consensus) and DSPG."""
    def meta(pkg, name):
        if name == "dpsvrg":
            return pkg.AlgoMeta(
                name=name, stepsize=lambda t: 0.1,
                outer_lengths=tuple(range(1, 12)),
                gossip_rounds=lambda k: k)
        return pkg.AlgoMeta(name=name, stepsize=lambda t: 0.1, num_steps=40)
    return [(meta(jpkg, n), meta(tpkg, n)) for n in ("dpsvrg", "dspg")]


@pytest.mark.parametrize("b", [1, 2, 3])
def test_auto_backend_rule_matches_reference(b):
    js = jgraphs.b_connected_ring_schedule(8, b)
    ts = tgraphs.b_connected_ring_schedule(8, b)
    for jm, tm in _metas(jalgorithm, talgorithm):
        want = jtransport.select_backend_name(js, jm)
        assert ttransport.select_backend_name(ts, tm) == want
        assert (ttransport.band_offset_union(ts, tm)
                == jtransport.band_offset_union(js, jm))
        # without a mesh "auto" names dense or banded, both ported now
        assert ttransport.resolve_backend("auto", ts, tm).name == want


@pytest.mark.parametrize("name", ["banded", "ppermute", "compressed"])
def test_unported_backends_raise(name):
    """Every transport of the reference is ported (ppermute runs over a
    process group, tests/test_torch_mesh.py): each name resolves to the
    reference's backend, and an unknown name raises."""
    ts = tgraphs.b_connected_ring_schedule(8, 2)
    meta = _metas(jalgorithm, talgorithm)[1][1]
    backend = ttransport.resolve_backend(name, ts, meta)
    assert backend.name == jtransport.GOSSIP_BACKENDS[name].name
    assert type(backend).__name__ == \
        type(jtransport.GOSSIP_BACKENDS[name]).__name__
    assert sorted(ttransport.GOSSIP_BACKENDS) == \
        sorted(jtransport.GOSSIP_BACKENDS)
    with pytest.raises(ValueError, match="unknown gossip backend"):
        ttransport.resolve_backend("carrier-pigeon", ts, meta)


def test_dense_backend_matches_reference():
    js = jgraphs.b_connected_ring_schedule(8, 2, seed=1)
    ts = tgraphs.b_connected_ring_schedule(8, 2, seed=1)
    jmeta, tmeta = _metas(jalgorithm, talgorithm)[1]
    jb, tb = jtransport.GOSSIP_BACKENDS["dense"], \
        ttransport.GOSSIP_BACKENDS["dense"]
    ja, ta = jb.prepare(js, jmeta), tb.prepare(ts, tmeta)
    for slot in range(6):
        for rounds in (1, 2, 5):
            jphi, tphi = jb.phi_for(ja, slot, rounds), \
                tb.phi_for(ta, slot, rounds)
            np.testing.assert_array_equal(jphi, tphi)
            assert (tb.bytes_per_step(ta, tphi, 30)
                    == jb.bytes_per_step(ja, jphi, 30))
            assert (tb.bytes_per_link(ta, tphi, 30)
                    == jb.bytes_per_link(ja, jphi, 30))
    x = {"w": np.zeros((8, 3), np.float32), "b": np.zeros((8,), np.float32)}
    assert ttransport.node_param_count(x) == jtransport.node_param_count(x)
