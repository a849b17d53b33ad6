"""The port's RMSNorm kernel package (``repro_torch.kernels.rmsnorm``) on
the CPU: its plain version and its wrapper against the JAX package's oracle
(``rmsnorm_ref``) and its Pallas kernel in interpret mode (``ops.rmsnorm``),
over the reference's own shape sweep (tests/test_kernels.py).  The CUDA
kernel itself runs only on a card (tests/test_torch_card.py).

Tolerances: float32 rtol 1e-5 / atol 1e-5 (the same formula in float32,
summed in other orders); bf16 one bf16 ulp (rtol 1.6e-2), since the
float32 result may round to either neighbour.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import ops as jops, ref as jref
from repro_torch.kernels.rmsnorm import ops, ref

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1.6e-2, atol=1e-5)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (0.1 * rng.normal(size=(shape[-1],))).astype(np.float32)
    if dtype == "bfloat16":      # round once, so both sides see the same bits
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, w


def _torch(a, dtype):
    return torch.from_numpy(a).to(TORCH_DTYPES[dtype])


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 64), (5, 256), (1, 2560),
                                   (13, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_jax_oracle(shape, dtype):
    x, w = _inputs(shape, dtype)
    got = ref.rmsnorm_ref(_torch(x, dtype), _torch(w, dtype))
    want = jref.rmsnorm_ref(_jax(x, dtype), _jax(w, dtype))
    assert got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# the widths around the CUDA kernel's register tiles (tests/test_torch_card.py
# :RMS_EDGE_DIMS): ragged 1 and 7, one bf16 vector 8, the models' 2304, 2560
# and 3584, and the first row past the float32 register tile
@pytest.mark.parametrize("shape", [(4, 1), (4, 7), (4, 8), (4, 2304),
                                   (133, 2560), (4, 3584), (1, 10248)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_the_jax_oracle_at_the_tile_edge_widths(shape, dtype):
    x, w = _inputs(shape, dtype, seed=2)
    got = ops.rmsnorm(_torch(x, dtype), _torch(w, dtype))
    want = jref.rmsnorm_ref(_jax(x, dtype), _jax(w, dtype))
    assert tuple(got.shape) == shape and got.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 64), (5, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_the_jax_kernel_in_interpret_mode(shape, dtype):
    """Rows that are not a multiple of 8 (3*7, 5) go through the port
    unpadded; the reference pads them for its TPU tiles."""
    x, w = _inputs(shape, dtype, seed=1)
    got = ops.rmsnorm(_torch(x, dtype), _torch(w, dtype))
    want = jops.rmsnorm(_jax(x, dtype), _jax(w, dtype), interpret=True)
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_wrapper_on_the_cpu_runs_the_plain_version_and_counts_nothing():
    x, w = _inputs((4, 64), "float32", seed=2)
    before = ops.launches
    got = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    assert ops.launches == before
    assert torch.equal(got, ref.rmsnorm_ref(torch.from_numpy(x),
                                            torch.from_numpy(w), eps=1e-5))


def test_wrapper_takes_a_strided_last_position():
    """x[:, -1:] of a (B, L, d) batch: rows one sequence apart."""
    x, w = _inputs((3, 9, 32), "float32", seed=3)
    xt = torch.from_numpy(x)[:, -1:]
    got = ops.rmsnorm(xt, torch.from_numpy(w))
    want = jref.rmsnorm_ref(jnp.asarray(x[:, -1]), jnp.asarray(w))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want),
                               **TOL["float32"])


def test_wrapper_refuses_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="not on meta"):
        ops.rmsnorm(x, torch.zeros(8, device="meta"))
