"""Parity of the port's per-step math with the JAX package: every entry of
the prox registry (apply, value, subgrad, fused_spec), the SVRG corrected
gradient, dense gossip, the stacked-tree helpers and the shared
prox-gossip update.  Same numpy inputs on both sides; float32 tolerance
rtol 1e-6 / atol 1e-6 (the same float32 formulas, summed in possibly
different orders), and exact equality where no sum is taken."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import algorithm as jalgorithm, gossip as jgossip, \
    graphs as jgraphs, prox as jprox, svrg as jsvrg
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import algorithm as talgorithm, gossip as tgossip, \
    graphs as tgraphs, prox as tprox, svrg as tsvrg

RTOL = 1e-6
ATOL = 1e-6

PROX_ARGS = {
    "l1": (0.05,),
    "squared_l2": (0.3,),
    "elastic_net": (0.05, 0.2),
    "group_lasso": (0.4,),
    "nuclear": (0.3,),
    "box": (-0.5, 0.7),
    "none": (),
}


def _tree(seed, m=4):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(m, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(m, 6)).astype(np.float32),
            "s": rng.normal(size=(6,)).astype(np.float32)}


def _close(got_torch, want_jax, exact=False):
    got = params_to_numpy(got_torch)
    want = jax.tree.map(np.asarray, want_jax)
    for k in want:
        if exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_registry_names_match():
    assert sorted(tprox.PROX_REGISTRY) == sorted(jprox.PROX_REGISTRY)
    assert sorted(PROX_ARGS) == sorted(jprox.PROX_REGISTRY)


@pytest.mark.parametrize("name", sorted(PROX_ARGS))
@pytest.mark.parametrize("alpha", [0.1, np.float32(0.37)])
def test_prox_registry_parity(name, alpha):
    jp = jprox.get_prox(name, *PROX_ARGS[name])
    tp = tprox.get_prox(name, *PROX_ARGS[name])
    assert tp.name == jp.name
    assert tp.fused_spec == jp.fused_spec
    x = _tree(len(name))
    jx = jax.tree.map(jnp.asarray, x)
    tx = params_from_numpy(x, "cpu")
    # the runner hands steps float32 scalars: jnp.float32 / a float32 value
    _close(tp.apply(tx, float(np.float32(alpha))),
           jp.apply(jx, jnp.float32(alpha)))
    np.testing.assert_allclose(float(tp.value(tx)), float(jp.value(jx)),
                               rtol=RTOL, atol=ATOL)
    assert (tp.subgrad is None) == (jp.subgrad is None)
    if tp.subgrad is not None:
        _close(tp.subgrad(tx), jp.subgrad(jx))


def test_l1_threshold_is_a_float32_product():
    """alpha * lam rounds in float32 on both sides, so a coordinate placed
    exactly at the threshold lands on the same side in both packages."""
    alpha, lam = 0.1, 0.07
    t = np.float32(alpha) * np.float32(lam)
    z = np.array([t, np.nextafter(t, np.float32(1)),
                  np.nextafter(t, np.float32(0)), -t], np.float32)
    want = np.asarray(jprox.l1(lam).apply(jnp.asarray(z), jnp.float32(alpha)))
    got = tprox.l1(lam).apply(torch.from_numpy(z), alpha).numpy()
    np.testing.assert_array_equal(got, want)
    got_dev = tprox.l1(lam).apply(torch.from_numpy(z),
                                  torch.tensor(alpha, dtype=torch.float32))
    np.testing.assert_array_equal(got_dev.numpy(), want)


def _logreg_case(seed, m=4, bsz=3, d=7):
    rng = np.random.default_rng(seed)
    batch = {"features": rng.normal(size=(m, bsz, d)).astype(np.float32),
             "labels": (rng.random((m, bsz)) < 0.5).astype(np.float32)}
    params = [rng.normal(size=(m, d)).astype(np.float32) for _ in range(3)]
    return batch, params


def _jloss(w, batch):
    z = batch["features"] @ w
    return jnp.mean(-batch["labels"] * z + jnp.log1p(jnp.exp(z)))


def _tloss(w, batch):
    z = batch["features"] @ w
    return torch.mean(-batch["labels"] * z + torch.log1p(torch.exp(z)))


def test_node_grad_fn_parity():
    batch, (x, _, _) = _logreg_case(0)
    want = jalgorithm.build_node_grad_fn(_jloss)(jnp.asarray(x), batch)
    got = talgorithm.build_node_grad_fn(_tloss)(
        torch.from_numpy(x), params_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_corrected_gradient_parity():
    batch, (x, snap, mu) = _logreg_case(1)
    want = jsvrg.corrected_gradient(
        jalgorithm.build_node_grad_fn(_jloss), jnp.asarray(x),
        jsvrg.SvrgState(jnp.asarray(snap), jnp.asarray(mu)), batch)
    got = tsvrg.corrected_gradient(
        talgorithm.build_node_grad_fn(_tloss), torch.from_numpy(x),
        tsvrg.SvrgState(torch.from_numpy(snap), torch.from_numpy(mu)),
        params_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_svrg_tree_helpers_parity():
    a, b = _tree(3), _tree(4)
    ja, jb = (jax.tree.map(jnp.asarray, t) for t in (a, b))
    ta, tb = (params_from_numpy(t, "cpu") for t in (a, b))
    _close(tsvrg.tree_add(ta, tb), jsvrg.tree_add(ja, jb), exact=True)
    _close(tsvrg.tree_sub(ta, tb), jsvrg.tree_sub(ja, jb), exact=True)
    _close(tsvrg.tree_axpy(0.5, ta, tb), jsvrg.tree_axpy(0.5, ja, jb))
    np.testing.assert_allclose(float(tsvrg.tree_norm(ta)),
                               float(jsvrg.tree_norm(ja)), rtol=RTOL)
    st = tsvrg.init_snapshot(ta, lambda p: tsvrg.tree_sub(p, tb))
    _close(st.full_grad, jsvrg.tree_sub(ja, jb), exact=True)


@pytest.mark.parametrize("m,b,rounds", [(8, 1, 1), (8, 2, 3), (5, 3, 4)])
def test_mix_stacked_dense_parity(m, b, rounds):
    js = jgraphs.b_connected_ring_schedule(m, b, seed=2)
    ts = tgraphs.b_connected_ring_schedule(m, b, seed=2)
    jphi = jgossip.multi_consensus_matrix(js, 1, rounds)
    tphi = tgossip.multi_consensus_matrix(ts, 1, rounds)
    np.testing.assert_array_equal(jphi, tphi)
    np.testing.assert_array_equal(
        jgossip.multi_consensus_matrix(js, 0, 9, k_max=4),
        tgossip.multi_consensus_matrix(ts, 0, 9, k_max=4))
    x = {k: v for k, v in _tree(m, m).items() if k != "s"}
    want = jgossip.mix_stacked(jphi, jax.tree.map(jnp.asarray, x))
    _close(tgossip.mix_stacked(tphi, params_from_numpy(x, "cpu")), want)
    # a float32 tensor phi (what the runner ships to the device) mixes alike
    _close(tgossip.mix_stacked(torch.as_tensor(tphi, dtype=torch.float32),
                               params_from_numpy(x, "cpu")), want)


def test_stacked_tree_helpers_parity():
    x = {k: v for k, v in _tree(9).items() if k != "s"}
    jx, tx = jax.tree.map(jnp.asarray, x), params_from_numpy(x, "cpu")
    _close(tgossip.node_mean(tx), jgossip.node_mean(jx))
    _close(tgossip.stack_tree(tgossip.node_mean(tx), 3),
           jgossip.stack_tree(jgossip.node_mean(jx), 3))


@pytest.mark.parametrize("prox_name", ["l1", "squared_l2", "none"])
def test_prox_gossip_update_parity(prox_name):
    batch, (x, v, _) = _logreg_case(5, m=8)
    phi = jgraphs.b_connected_ring_schedule(8, 2).consensus_rounds(0, 2)
    want = jalgorithm.prox_gossip_update(
        jnp.asarray(x), jnp.asarray(v), phi, jnp.float32(0.3),
        jprox.get_prox(prox_name, *PROX_ARGS[prox_name]))
    got = talgorithm.prox_gossip_update(
        torch.from_numpy(x), torch.from_numpy(v), phi, 0.3,
        tprox.get_prox(prox_name, *PROX_ARGS[prox_name]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
