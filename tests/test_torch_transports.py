"""The port's banded and compressed transports against the JAX package's:
the cyclic-band form (``BandedPhi``, ``banded_to_dense``,
``mix_stacked_banded``), the wire-byte and per-link accounting (equal
exactly), the ``"auto"`` rule, and compressed gossip with error feedback
(integer payloads and scales equal exactly, mixes at float32 tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as jalgorithm, compression as jcompression, \
    gossip as jgossip, graphs as jgraphs, transport as jtransport
from repro_torch.core import algorithm as talgorithm, \
    compression as tcompression, gossip as tgossip, graphs as tgraphs, \
    transport as ttransport

ATOL = 1e-6
RTOL = 1e-6


def _metas(pkg):
    """Transport-relevant metas: DPSVRG with faithful multi-consensus,
    DPSVRG capped at 2 rounds, DSPG, and loopless DPSVRG at 2 rounds."""
    return {
        "dpsvrg": pkg.AlgoMeta(name="dpsvrg", stepsize=lambda t: 0.1,
                               outer_lengths=tuple(range(1, 12)),
                               gossip_rounds=lambda k: k),
        "dpsvrg_kmax2": pkg.AlgoMeta(name="dpsvrg", stepsize=lambda t: 0.1,
                                     outer_lengths=(5, 6, 7),
                                     gossip_rounds=lambda k: min(k, 2)),
        "dspg": pkg.AlgoMeta(name="dspg", stepsize=lambda t: 0.1,
                             num_steps=40),
        "loopless": pkg.AlgoMeta(name="loopless_dpsvrg",
                                 stepsize=lambda t: 0.1, num_steps=30,
                                 gossip_rounds=lambda t: 2,
                                 snapshot_prob=0.1),
    }


def _circulant(pkg, m=8):
    w = np.zeros((m, m))
    for off, c in ((0, 0.4), (1, 0.2), (-1, 0.2), (2, 0.1), (-2, 0.1)):
        w[np.arange(m), (np.arange(m) + off) % m] += c
    return pkg.static_schedule(w, name="circulant")


def _schedules(pkg):
    return {f"ring_b{b}": pkg.b_connected_ring_schedule(8, b, seed=b)
            for b in (1, 2, 3)} | {"circulant": _circulant(pkg)}


SCHEDULES = ["ring_b1", "ring_b2", "ring_b3", "circulant"]
METAS = ["dpsvrg", "dpsvrg_kmax2", "dspg", "loopless"]


# ---------------------------------------------------------------------------
# the banded wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", SCHEDULES)
def test_banded_phi_from_dense_matches_reference(sched):
    js, ts = _schedules(jgraphs)[sched], _schedules(tgraphs)[sched]
    for rounds in (1, 2):
        offsets = jgossip.schedule_band_offsets(js, rounds)
        assert tgossip.schedule_band_offsets(ts, rounds) == offsets
        for t0 in range(js.period):
            phi = js.consensus_rounds(t0, rounds)
            jb = jgossip.BandedPhi.from_dense(phi, offsets)
            tb = tgossip.BandedPhi.from_dense(ts.consensus_rounds(t0, rounds),
                                              offsets)
            assert tb.offsets == jb.offsets
            np.testing.assert_array_equal(tb.coeffs, jb.coeffs)
            dense = tgossip.banded_to_dense(tb.offsets, tb.coeffs)
            np.testing.assert_array_equal(
                dense.numpy(),
                np.asarray(jgossip.banded_to_dense(jb.offsets, jb.coeffs)))
            np.testing.assert_allclose(dense.numpy(), phi, atol=1e-7)


def test_bands_for_phi_refuses_mass_outside_the_offsets():
    phi = tgraphs.b_connected_ring_schedule(8, 1).consensus_rounds(0, 3)
    with pytest.raises(ValueError, match="outside"):
        tgossip.bands_for_phi(phi, (0, 1))


@pytest.mark.parametrize("sched", SCHEDULES)
def test_mix_stacked_banded_matches_reference(sched):
    rng = np.random.default_rng(len(sched))
    tree = {"w": rng.normal(size=(8, 50)).astype(np.float32),
            "b": rng.normal(size=(8, 3, 2)).astype(np.float32),
            "s": rng.normal(size=(8,)).astype(np.float32)}
    js, ts = _schedules(jgraphs)[sched], _schedules(tgraphs)[sched]
    offsets = jgossip.schedule_band_offsets(js, 1)
    for t0 in range(js.period):
        jphi = jgossip.BandedPhi.from_dense(js.consensus_rounds(t0, 1),
                                            offsets)
        tphi = tgossip.BandedPhi.from_dense(ts.consensus_rounds(t0, 1),
                                            offsets)
        want = jgossip.mix_stacked(jphi, {k: jnp.asarray(v)
                                          for k, v in tree.items()})
        got = tgossip.mix_stacked(tphi, {k: torch.from_numpy(v)
                                         for k, v in tree.items()})
        dense = tgossip.mix_stacked(ts.consensus_rounds(t0, 1),
                                    {k: torch.from_numpy(v)
                                     for k, v in tree.items()})
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got[k].numpy(), dense[k].numpy(),
                                       rtol=RTOL, atol=ATOL)


def test_banded_phi_stacks_and_slices_as_a_pytree():
    """The offsets ride along as the pytree context when the runner stacks
    per-step phis and slices one step back out."""
    from torch.utils import _pytree as pytree
    ts = tgraphs.b_connected_ring_schedule(8, 2)
    offsets = tgossip.schedule_band_offsets(ts, 1)
    phis = [tgossip.BandedPhi.from_dense(ts.consensus_rounds(t, 1), offsets)
            for t in range(3)]
    leaves, spec = pytree.tree_flatten(phis[0])
    assert len(leaves) == 1
    stacked = pytree.tree_unflatten(
        [torch.as_tensor(np.stack([p.coeffs for p in phis]))], spec)
    assert stacked.offsets == offsets
    assert tuple(stacked.coeffs.shape) == (3, len(offsets), 8)
    one = pytree.tree_map(lambda a: a[1], stacked)
    np.testing.assert_array_equal(one.coeffs.numpy(), phis[1].coeffs)


# ---------------------------------------------------------------------------
# accounting and the "auto" rule
# ---------------------------------------------------------------------------

def _backend_pairs(name, bits=8):
    if name == "dense" or name == "banded":
        return (jtransport.GOSSIP_BACKENDS[name],
                ttransport.GOSSIP_BACKENDS[name])
    inner = name.split("/")[1]
    return (jtransport.CompressedBackend(inner=inner, bits=bits),
            ttransport.CompressedBackend(inner=inner, bits=bits))


@pytest.mark.parametrize("backend,bits", [("banded", None)] + [
    (f"compressed/{inner}", bits) for inner in ("dense", "banded")
    for bits in (4, 8, 12)])
@pytest.mark.parametrize("sched", ["ring_b1", "ring_b3", "circulant"])
def test_wire_and_link_bytes_match_reference_exactly(sched, backend, bits):
    js, ts = _schedules(jgraphs)[sched], _schedules(tgraphs)[sched]
    # DSPG gossips one round a step, loopless DPSVRG two
    for key, rounds in (("dspg", 1), ("loopless", 2)):
        jm, tm = _metas(jalgorithm)[key], _metas(talgorithm)[key]
        jb, tb = _backend_pairs(backend, bits)
        ja, ta = jb.prepare(js, jm), tb.prepare(ts, tm)
        for slot in range(2 * js.period):
            jphi, tphi = jb.phi_for(ja, slot, rounds), tb.phi_for(ta, slot,
                                                                  rounds)
            for count in (30, 1001):
                want = jb.bytes_per_step(ja, jphi, count)
                assert tb.bytes_per_step(ta, tphi, count) == want
                links = tb.bytes_per_link(ta, tphi, count)
                assert links == jb.bytes_per_link(ja, jphi, count)
                assert sum(links.values()) == want


@pytest.mark.parametrize("sched", SCHEDULES)
def test_auto_names_the_reference_backend(sched):
    js, ts = _schedules(jgraphs)[sched], _schedules(tgraphs)[sched]
    jmetas, tmetas = _metas(jalgorithm), _metas(talgorithm)
    for key in METAS:
        want = jtransport.resolve_backend("auto", js, jmetas[key])
        got = ttransport.resolve_backend("auto", ts, tmetas[key])
        assert got.name == want.name
        assert type(got).__name__ == type(want).__name__


def test_banded_on_a_saturated_union_warns_as_the_reference():
    ts = tgraphs.b_connected_ring_schedule(8, 1)
    with pytest.warns(RuntimeWarning, match="band offsets"):
        ttransport.GOSSIP_BACKENDS["banded"].prepare(
            ts, _metas(talgorithm)["dpsvrg"])


def test_mix_matrix_lowers_banded_and_not_compressed():
    ts = tgraphs.b_connected_ring_schedule(8, 2)
    meta = _metas(talgorithm)["dspg"]
    banded = ttransport.GOSSIP_BACKENDS["banded"]
    aux = banded.prepare(ts, meta)
    phi = banded.phi_for(aux, 3, 1)
    np.testing.assert_allclose(ttransport.mix_matrix(phi).numpy(),
                               ts.consensus_rounds(3, 1), atol=1e-7)
    comp = ttransport.CompressedBackend(inner="banded")
    caux = comp.prepare(ts, meta)
    assert ttransport.mix_matrix(comp.phi_for(caux, 3, 1)) is None
    dense = ts.consensus_rounds(3, 1)
    assert ttransport.mix_matrix(dense) is dense


# ---------------------------------------------------------------------------
# compressed gossip with error feedback
# ---------------------------------------------------------------------------

def _half_way_rows():
    """Rows whose values land exactly half-way between codes at 8 bits: the
    row's peak is 127, so the scale is 1 and x / scale is x itself."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0],
                   np.float32)
    return np.stack([row, -row, row * 0.5])


@pytest.mark.parametrize("bits", [4, 8, 12])
@pytest.mark.parametrize("shape", [(8,), (8, 7), (8, 3, 5)])
def test_quantize_int_leaf_matches_reference_exactly(shape, bits):
    rng = np.random.default_rng(bits + len(shape))
    for x in (rng.normal(size=shape).astype(np.float32),
              np.zeros(shape, np.float32)):
        jcode, jscale = jcompression.quantize_int_leaf(jnp.asarray(x), bits)
        code, scale = tcompression.quantize_int_leaf(torch.from_numpy(x),
                                                     bits)
        assert str(code.dtype).split(".")[-1] == str(jcode.dtype)
        np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        np.testing.assert_array_equal(
            tcompression.quantize_leaf(torch.from_numpy(x), bits).numpy(),
            np.asarray(jcompression.quantize_leaf(jnp.asarray(x), bits)))


def test_quantize_rounds_half_to_even_as_the_reference():
    x = _half_way_rows()
    jcode, _ = jcompression.quantize_int_leaf(jnp.asarray(x), 8)
    code, _ = tcompression.quantize_int_leaf(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(code.numpy(), np.asarray(jcode))
    assert code[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 3]


@pytest.mark.parametrize("inner", ["dense", "banded"])
def test_compressed_mix_and_error_feedback_match_reference(inner):
    rng = np.random.default_rng(7)
    js = jgraphs.b_connected_ring_schedule(8, 2, seed=3)
    ts = tgraphs.b_connected_ring_schedule(8, 2, seed=3)
    jm, tm = _metas(jalgorithm)["dspg"], _metas(talgorithm)["dspg"]
    jb = jtransport.CompressedBackend(inner=inner, bits=8)
    tb = ttransport.CompressedBackend(inner=inner, bits=8)
    ja, ta = jb.prepare(js, jm), tb.prepare(ts, tm)
    x0 = {"w": rng.normal(size=(8, 40)).astype(np.float32),
          "s": rng.normal(size=(8,)).astype(np.float32)}
    jx = {k: jnp.asarray(v) for k, v in x0.items()}
    tx = {k: torch.from_numpy(v) for k, v in x0.items()}
    jstate = jb.init_mix_state(ja, jx)
    tstate = tb.init_mix_state(ta, tx)
    for slot in range(6):
        jphi, tphi = jb.phi_for(ja, slot, 1), tb.phi_for(ta, slot, 1)
        jx, jstate = jcompression.mix_with_state(jphi, jx, jstate)
        tphi = ttransport.pytree.tree_map(torch.as_tensor, tphi)
        tx, tstate = tcompression.mix_with_state(tphi, tx, tstate)
        for k in x0:
            np.testing.assert_allclose(tx[k].numpy(), np.asarray(jx[k]),
                                       rtol=1e-5, atol=ATOL)
            np.testing.assert_allclose(tstate.error[k].numpy(),
                                       np.asarray(jstate.error[k]),
                                       rtol=1e-5, atol=ATOL)


def test_compressed_phi_needs_a_mix_state():
    ts = tgraphs.b_connected_ring_schedule(8, 2)
    phi = tcompression.CompressedPhi(ts.consensus_rounds(0, 1), 8)
    x = {"w": torch.ones(8, 3)}
    with pytest.raises(TypeError, match="stateful"):
        tgossip.mix_stacked(phi, x)
    with pytest.raises(ValueError, match="CompressionState"):
        tcompression.mix_with_state(phi, x, None)
    mixed, state = tcompression.mix_with_state(ts.consensus_rounds(0, 1), x,
                                               None)
    assert state is None and mixed["w"].shape == (8, 3)
