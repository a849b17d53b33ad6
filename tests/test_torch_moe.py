"""The port's MoE mixer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``): the same numpy inputs and parameters (the
reference initializes them, ``convert.params_from_numpy`` carries them
across) through both.

Routing (expert indices, slots and the keep mask) is compared exactly.
Outputs: float32 within rtol 1e-5 and atol 1e-6 of the largest |y| (the
reference's expert init takes its fan-in over the expert axis, so outputs
reach 10-20, and an entry that cancels to near 0 keeps the rounding of
those terms); aux within rtol 1e-5 / atol 1e-6.  bf16 outputs within 2^-5
of the largest |y|: each framework rounds the expert products (h, u,
silu(h) u and the output) to bf16 from float32 sums in its own order, so
entries land a bf16 ulp or two apart and the down product carries that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon, moe as jmoe
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as tcommon, moe as tmoe

torch.set_num_threads(1)

AUX_TOL = dict(rtol=1e-5, atol=1e-6)
Y_RTOL = {"float32": 1e-5, "bfloat16": 0.0}
Y_ATOL_OF_MAX = {"float32": 1e-6, "bfloat16": 2.0 ** -5}


def _specs(**kw):
    kw = dict(dict(d_model=32, d_ff=48, num_experts=4), **kw)
    return jmoe.MoESpec(**kw), tmoe.MoESpec(**kw)


def _params(jspec, dtype="float32", seed=0):
    jp = jmoe.init_moe(jcommon.KeyGen(jax.random.PRNGKey(seed)), jspec,
                       jnp.dtype(dtype))
    # numpy has no bf16 that torch takes: carry float32 values (exact for
    # bf16 ones) and cast back
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        jp), "cpu")
    return jp, {k: v.to(getattr(torch, dtype)) for k, v in tp.items()}


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _jax_route(params, spec, xt):
    """The reference's routing (``repro.models.moe._moe_tokens``, its first
    lines), returned rather than consumed: (experts, slots, keep)."""
    t = xt.shape[0]
    e, k = spec.num_experts, spec.top_k
    capacity = max(int(t * k / e * spec.capacity_factor), 1)
    logits = (xt @ params["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    prev_counts = jnp.zeros((e,), jnp.int32)
    slots, keeps = [], []
    for choice in range(k):
        onehot = jax.nn.one_hot(expert_idx[:, choice], e, dtype=jnp.int32)
        pos_in_e = jnp.cumsum(onehot, axis=0) - onehot
        pos = jnp.take_along_axis(
            pos_in_e, expert_idx[:, choice:choice + 1], axis=1)[:, 0]
        pos = pos + prev_counts[expert_idx[:, choice]]
        prev_counts = prev_counts + onehot.sum(axis=0)
        keep = pos < capacity
        slots.append(jnp.where(keep, pos, capacity))
        keeps.append(keep)
    return (np.asarray(expert_idx), np.stack(slots, 1), np.stack(keeps, 1))


def _assert_y(ty, jy, dtype):
    want = np.asarray(jnp.asarray(jy, jnp.float32))
    np.testing.assert_allclose(
        ty.float().numpy(), want, rtol=Y_RTOL[dtype],
        atol=Y_ATOL_OF_MAX[dtype] * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.5, 4.0],
                         ids=["drops", "lossless"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shared", [False, True], ids=["", "shared"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_forward_and_routing_match(top_k, shared, groups,
                                       capacity_factor, dtype):
    jspec, tspec = _specs(top_k=top_k, shared_expert=shared,
                          dispatch_groups=groups,
                          capacity_factor=capacity_factor)
    jp, tp = _params(jspec, dtype)
    jx, tx = _x((4, 8, 32), dtype)
    jy, jaux = jmoe.moe_forward(jp, jspec, jx)
    ty, taux = tmoe.moe_forward(tp, tspec, tx)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == tx.shape
    _assert_y(ty, jy, dtype)
    np.testing.assert_allclose(float(taux), float(jaux), **AUX_TOL)
    # routing, group by group as the dispatch sees the tokens
    dropped = 0
    for jxt, txt in zip(jx.reshape(groups, -1, 32), tx.reshape(groups, -1,
                                                                32)):
        je, js, jk = _jax_route(jp, jspec, jxt)
        _, _, te, ts, tk = tmoe.route(tp, tspec, txt)
        np.testing.assert_array_equal(te.numpy(), je)
        np.testing.assert_array_equal(ts.numpy(), js)
        np.testing.assert_array_equal(tk.numpy(), jk)
        dropped += int((~jk).sum())
    assert (dropped > 0) == (capacity_factor < 1.0)


def test_capacity_is_the_reference_formula():
    for t, k, e, cf in [(32, 1, 4, 1.25), (4, 1, 128, 1.25), (6144, 1, 16,
                                                              1.25),
                        (10, 2, 3, 0.7), (1, 1, 16, 1.25)]:
        spec = tmoe.MoESpec(d_model=8, d_ff=8, num_experts=e, top_k=k,
                            capacity_factor=cf)
        assert tmoe.capacity(spec, t) == max(int(t * k / e * cf), 1)
    spec = tmoe.MoESpec(d_model=8, d_ff=8, num_experts=128)
    assert tmoe.capacity(spec, 4) == 1       # a decode step of 4 slots


def test_ties_go_to_the_lower_expert_as_in_jax_top_k():
    """Experts 1 and 3 share a router column, so their probabilities tie
    exactly for every token; jax.lax.top_k takes the lower index first, so
    3 is chosen only after 1, as the second choice."""
    jspec, tspec = _specs(top_k=2, capacity_factor=4.0)
    jp, _ = _params(jspec)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, tx = _x((16, 32), "float32", seed=3)
    je, js, jk = _jax_route(jp, jspec, jx)
    _, _, te, ts, tk = tmoe.route(tp, tspec, tx)
    np.testing.assert_array_equal(te.numpy(), je)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert (je[:, 1] == 3).any()
    np.testing.assert_array_equal(je[:, 1] == 3, je[:, 0] == 1)
    assert not (je[:, 0] == 3).any()


def test_init_moe_has_the_reference_tree_and_distributions():
    jspec, tspec = _specs(num_experts=8, shared_expert=True)
    jp, _ = _params(jspec)
    tp = tmoe.init_moe(tcommon.make_generator(0, "cpu"), tspec)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    # fan-in is the first axis, the expert axis for the expert weights
    for k in ("w_gate", "w_up", "w_down"):
        assert float(tp[k].abs().max()) <= 2.0 / np.sqrt(8) + 1e-6
    assert float(tp["router"].abs().max()) <= 0.04 + 1e-7
    assert float(tp["shared_gate"].abs().max()) <= 2.0 / np.sqrt(32) + 1e-6
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)


# ---------------------------------------------------------------------------
# the reference's own MoE checks (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

def test_moe_lossless_capacity_matches_dense_mixture():
    """With capacity >= tokens, scatter-dispatch MoE == per-token gated sum
    of expert FFNs computed densely."""
    spec = tmoe.MoESpec(d_model=16, d_ff=32, num_experts=4, top_k=2,
                        capacity_factor=8.0)
    params = tmoe.init_moe(tcommon.make_generator(0, "cpu"), spec)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 6, 16))
                         .astype(np.float32))
    y, aux = tmoe.moe_forward(params, spec, x)
    p = {k: v.numpy() for k, v in params.items()}
    xt = x.numpy().reshape(-1, 16)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    ref = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[:2]
        g = probs[t][top] / probs[t][top].sum()
        for gi, e in zip(g, top):
            a = xt[t] @ p["w_gate"][e]
            u = xt[t] @ p["w_up"][e]
            silu = a / (1 + np.exp(-a)) * u
            ref[t] += gi * (silu @ p["w_down"][e])
    np.testing.assert_allclose(y.numpy().reshape(-1, 16), ref, atol=2e-4)
    assert float(aux) > 0.5  # load-balance stat near E * (1/E) * 1 = 1


def test_moe_capacity_drops_tokens():
    """Tiny capacity forces drops; output stays finite and drops show up as
    tokens whose output is only the shared/zero path."""
    spec = tmoe.MoESpec(d_model=8, d_ff=16, num_experts=2, top_k=1,
                        capacity_factor=0.25)
    params = tmoe.init_moe(tcommon.make_generator(2, "cpu"), spec)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 16, 8))
                         .astype(np.float32))
    y, aux = tmoe.moe_forward(params, spec, x)
    assert bool(torch.isfinite(y).all())
    # capacity = 16*1/2*0.25 = 2 per expert -> at most 4 non-dropped tokens
    nonzero = y.abs().sum(-1) > 1e-9
    assert int(nonzero.sum()) <= 4


# ---------------------------------------------------------------------------
# under the trainer's vmap over nodes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_vmapped_grads_equal_per_node_grads(groups):
    """torch.func.vmap(torch.func.grad(...)) through moe_forward, as the
    trainer computes per-node gradients, equals each node's own gradient,
    with capacity dropping tokens; and nested under a second vmap (the
    cells of train_sweep)."""
    spec = tmoe.MoESpec(d_model=16, d_ff=24, num_experts=4, top_k=2,
                        capacity_factor=0.75, shared_expert=True,
                        dispatch_groups=groups)
    base = tmoe.init_moe(tcommon.make_generator(0, "cpu"), spec)
    rng = np.random.default_rng(4)
    m = 3
    stacked = {k: v[None] + torch.from_numpy(
        0.01 * rng.normal(size=(m,) + tuple(v.shape)).astype(np.float32))
        for k, v in base.items()}
    x = torch.from_numpy(rng.normal(size=(m, 2, 6, 16)).astype(np.float32))

    def loss(p, xx):
        y, aux = tmoe.moe_forward(p, spec, xx)
        return (y ** 2).mean() + 0.01 * aux

    grads = torch.func.vmap(torch.func.grad(loss))(stacked, x)
    for i in range(m):
        gi = torch.func.grad(loss)({k: v[i] for k, v in stacked.items()},
                                   x[i])
        for k in gi:
            torch.testing.assert_close(grads[k][i], gi[k], rtol=1e-5,
                                       atol=1e-6)
    cells = torch.func.vmap(torch.func.vmap(torch.func.grad(loss)))(
        {k: torch.stack([v, v]) for k, v in stacked.items()},
        torch.stack([x, x]))
    for k in grads:
        torch.testing.assert_close(cells[k][1], grads[k], rtol=1e-5,
                                   atol=1e-6)
