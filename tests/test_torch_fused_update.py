"""The fused resident step of the port (``repro_torch.kernels.fused_update``).

On the CPU: the plain PyTorch version against the JAX package's oracle
``fused_step_ref`` for both rules x three proxes at four shapes (rtol 1e-5 /
atol 1e-6: the same float32 formulas, the mix summed in a different order),
the wrapper's device routing and launch count, and the stacked layout.

The kernel itself runs only on a card: see ``tests/test_torch_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_update import ops as jops, ref as jref
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import graphs
from repro_torch.kernels.fused_update import ops, ref

RTOL = 1e-5
ATOL = 1e-6

SHAPES = [(8, 30), (5, 200), (8, 1000), (8, 131072)]


def _case(m, d, rule, seed):
    rng = np.random.default_rng(seed)
    n = 4 if rule == "svrg" else 2
    streams = [rng.normal(size=(m, d)).astype(np.float32) for _ in range(n)]
    w = graphs.b_connected_ring_schedule(m, 2, seed=seed).consensus_rounds(
        0, 3).astype(np.float32)
    return w, streams


@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("prox_kind", ref.FUSED_PROXES)
@pytest.mark.parametrize("rule", ref.FUSED_RULES)
def test_plain_version_matches_jax_oracle(rule, prox_kind, m, d):
    alpha, lam = 0.07, 0.02
    w, streams = _case(m, d, rule, seed=d + m)
    want = jref.fused_step_ref(
        jnp.asarray(w), tuple(jnp.asarray(s) for s in streams),
        jnp.float32(alpha), jnp.float32(lam), m=m, rule=rule,
        prox_kind=prox_kind)
    got = ops.fused_step_buf(torch.from_numpy(w),
                             [torch.from_numpy(s) for s in streams],
                             alpha, lam, rule=rule, prox_kind=prox_kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_tensors_run_the_plain_version_without_a_launch():
    w, streams = _case(8, 64, "svrg", seed=0)
    before = ops.launches
    got = ops.fused_step_buf(torch.from_numpy(w),
                             [torch.from_numpy(s) for s in streams], 0.1,
                             0.01)
    want = ref.fused_step_ref(torch.from_numpy(w),
                              [torch.from_numpy(s) for s in streams], 0.1,
                              0.01)
    assert torch.equal(got, want)
    assert ops.launches == before


def test_other_devices_raise_instead_of_falling_back():
    w = torch.eye(4, device="meta")
    streams = [torch.empty(4, 16, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="not on meta"):
        ops.fused_step_buf(w, streams, 0.1, 0.01, rule="sgd")


def test_alpha_as_device_scalar_matches_python_float():
    """The resident runner passes alpha as a 0-d float32 tensor view of its
    staged step sizes; the result equals passing the float32 value."""
    w, streams = _case(8, 50, "svrg", seed=4)
    tw, ts = torch.from_numpy(w), [torch.from_numpy(s) for s in streams]
    alphas = torch.tensor([0.3, 0.05], dtype=torch.float32)
    got = ops.fused_step_buf(tw, ts, alphas[1], 0.2)
    want = ops.fused_step_buf(tw, ts, float(np.float32(0.05)), 0.2)
    assert torch.equal(got, want)


def test_fused_resident_step_tree_matches_jax():
    """Multi-leaf trees flatten through one stacked (m, d) buffer and come
    back with their structure, shapes and dtypes."""
    rng = np.random.default_rng(3)
    m, alpha, lam = 4, 0.1, 0.02

    def tree():
        return {"a": rng.normal(size=(m, 6)).astype(np.float32),
                "b": rng.normal(size=(m, 2, 3)).astype(np.float32)}

    x, gn, gs, mu = tree(), tree(), tree(), tree()
    w = rng.dirichlet(np.ones(m), size=m).astype(np.float32)
    want = jops.fused_resident_step(
        jnp.asarray(w), jax.tree.map(jnp.asarray, x),
        tuple(jax.tree.map(jnp.asarray, t) for t in (gn, gs, mu)),
        alpha, lam, rule="svrg", prox_kind="l1", impl="ref")
    got = ops.fused_resident_step(
        torch.from_numpy(w), params_from_numpy(x, "cpu"),
        tuple(params_from_numpy(t, "cpu") for t in (gn, gs, mu)),
        alpha, lam, rule="svrg", prox_kind="l1")
    got = params_to_numpy(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL)


def test_flatten_stacked_layout():
    x = {"a": torch.randn(3, 4), "b": torch.randn(3, 2, 5)}
    buf, aux = ops.flatten_stacked(x, 3)
    assert buf.shape == (3, 14) and buf.is_contiguous()
    assert ops.tree_node_dim(x) == 14
    back = ops.unflatten_stacked(buf, aux)
    for k in x:
        assert torch.equal(back[k], x[k])
    # one contiguous float32 leaf is used in place, not copied
    single = torch.randn(8, 30)
    assert ops.flatten_stacked(single, 8)[0].data_ptr() == single.data_ptr()


def test_auto_threshold():
    assert not ops.fused_wins(ops.FUSED_MIN_D - 1)
    assert ops.fused_wins(ops.FUSED_MIN_D)
    assert ops.fused_wins(131072)
