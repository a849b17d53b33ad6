"""The elementwise fused-update kernels of the port (``svrg_step`` and
``mix_prox`` in ``repro_torch.kernels.fused_update``) and the flat-buffer
layout (``flatten_tree`` / ``unflatten_tree``).

On the CPU the wrappers run their plain versions.  They are held against
the JAX package's Pallas kernels, run as ``tests/test_kernels.py`` runs them
off the TPU (interpret mode), and against the reference's jnp oracles, at
atol 1e-6 (the same float32 formulas).  The plain versions round their
Python scalars to float32, as the CUDA kernels receive them, which the
numpy float32 checks below pin bit for bit.  The kernels themselves run
only on a card: see ``tests/test_torch_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_update import ops as jops, ref as jref
from repro_torch.kernels.fused_update import ops, ref

ATOL = 1e-6
MIX_CASES = [(1.0, 0.0, 0.0, 0.0), (1 / 3, 1 / 3, 1 / 3, 0.01),
             (0.5, 0.25, 0.25, 0.3)]


def _buffers(rows, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, 1024)).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("alpha", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("rows", [8, 24])
def test_svrg_step_matches_jax(rows, alpha):
    bufs = _buffers(rows, 4, rows)
    want_kernel = np.asarray(jops.svrg_step(*map(jnp.asarray, bufs), alpha))
    want_ref = np.asarray(jref.svrg_step_ref(*map(jnp.asarray, bufs), alpha))
    got = ops.svrg_step(*map(torch.from_numpy, bufs), alpha).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", MIX_CASES)
@pytest.mark.parametrize("rows", [8, 40])
def test_mix_prox_matches_jax(rows, case):
    bufs = _buffers(rows, 3, rows + 100)
    want_kernel = np.asarray(jops.mix_prox(*map(jnp.asarray, bufs), *case))
    want_ref = np.asarray(jref.mix_prox_ref(*map(jnp.asarray, bufs), *case))
    got = ops.mix_prox(*map(torch.from_numpy, bufs), *case).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=0)


def test_inner_step_ref_matches_jax():
    bufs = _buffers(16, 6, 3)
    args = (1 / 3, 1 / 3, 1 / 3, 0.05, 0.01)
    want = np.asarray(jref.inner_step_ref(*map(jnp.asarray, bufs), *args))
    got = ref.inner_step_ref(*map(torch.from_numpy, bufs), *args).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_versions_round_like_the_kernels():
    """Every product and sum a float32 operation of its own, scalars rounded
    to float32 first, in the kernels' order: numpy float32 gives the same
    bits."""
    x, gn, gs, mu = _buffers(8, 4, 9)
    f = np.float32
    v = (gn - gs) + mu
    np.testing.assert_array_equal(
        ops.svrg_step(*map(torch.from_numpy, (x, gn, gs, mu)), 0.1).numpy(),
        x - f(0.1) * v)
    w_s, w_u, w_d, th = 0.3, 0.45, 0.25, 0.07
    z = (f(w_s) * x + f(w_u) * gn) + f(w_d) * gs
    want = np.sign(z) * np.maximum(np.abs(z) - f(th), f(0))
    np.testing.assert_array_equal(
        ops.mix_prox(*map(torch.from_numpy, (x, gn, gs)), w_s, w_u, w_d,
                     th).numpy(), want)


@pytest.mark.parametrize("held", ["all", "weights", "thresh"])
@pytest.mark.parametrize("case", MIX_CASES)
def test_mix_prox_weights_as_tensors_equal_floats(case, held):
    """Weights and threshold given as one-element float32 tensors (what a
    node-sharded step reads from its staged coefficients) give the bits of
    the same Python floats, also when only some are tensors."""
    bufs = [torch.from_numpy(b) for b in _buffers(8, 3, 5)]
    as_tensor = {"all": (1, 1, 1, 1), "weights": (1, 1, 1, 0),
                 "thresh": (0, 0, 0, 1)}[held]
    args = [torch.tensor(v, dtype=torch.float32) if t else v
            for v, t in zip(case, as_tensor)]
    np.testing.assert_array_equal(ops.mix_prox(*bufs, *args).numpy(),
                                  ops.mix_prox(*bufs, *case).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (3, 5, 7)])
def test_any_shape_on_the_cpu_runs_the_plain_version(shape):
    rng = np.random.default_rng(len(shape))
    x, gn, gs, mu = (torch.as_tensor(rng.normal(size=shape),
                                     dtype=torch.float32) for _ in range(4))
    alpha = torch.tensor(0.05)
    before = (ops.launches_svrg_step, ops.launches_mix_prox)
    q = ops.svrg_step(x, gn, gs, mu, alpha)
    assert torch.equal(q, ref.svrg_step_ref(x, gn, gs, mu, alpha))
    out = ops.mix_prox(q, gn, gs, 0.5, 0.25, 0.25, 0.01)
    assert torch.equal(out, ref.mix_prox_ref(q, gn, gs, 0.5, 0.25, 0.25,
                                             0.01))
    assert out.shape == shape
    # the CPU never launches a kernel
    assert (ops.launches_svrg_step, ops.launches_mix_prox) == before


def test_other_devices_are_refused():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.svrg_step(x, x, x, x, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        ops.mix_prox(x, x, x, 1.0, 0.0, 0.0, 0.0)


def _tree(rng):
    return {"a": rng.normal(size=(2, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(3,)).astype(np.float16),
                  "d": rng.normal(size=(7, 3)).astype(np.float32)},
            "e": rng.normal(size=(3000,)).astype(np.float32)}


def test_flatten_tree_equals_reference_buffers():
    tree = _tree(np.random.default_rng(0))
    jbuf, _ = jops.flatten_tree({k: jnp.asarray(v) if not isinstance(v, dict)
                                 else {kk: jnp.asarray(vv)
                                       for kk, vv in v.items()}
                                 for k, v in tree.items()})
    tt = {k: torch.from_numpy(v) if not isinstance(v, dict)
          else {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in tree.items()}
    buf, aux = ops.flatten_tree(tt)
    assert buf.shape == jbuf.shape
    assert buf.shape[1] == ops.BLOCK_COLS
    assert buf.shape[0] % ops.BLOCK_ROWS == 0
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    back = ops.unflatten_tree(buf, aux)
    for leaf, orig in ((back["a"], tt["a"]), (back["b"]["c"], tt["b"]["c"]),
                       (back["b"]["d"], tt["b"]["d"]), (back["e"], tt["e"])):
        assert leaf.dtype == orig.dtype and leaf.shape == orig.shape
        assert torch.equal(leaf, orig)


def test_flatten_tree_pads_with_zeros_to_whole_tiles():
    buf, aux = ops.flatten_tree({"w": torch.ones(8 * 1024 + 1)})
    assert buf.shape == (16, 1024)
    assert float(buf.sum()) == 8 * 1024 + 1
    assert torch.equal(ops.unflatten_tree(buf, aux)["w"],
                       torch.ones(8 * 1024 + 1))
