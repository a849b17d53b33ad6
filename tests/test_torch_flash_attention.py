"""The port's flash attention kernel package
(``repro_torch.kernels.flash_attention``) on the CPU: its plain version and
its wrapper against the JAX package's oracle (``attention_ref``) and its
Pallas kernel in interpret mode (``ops.flash_attention``), over the
reference's own variant sweep (tests/test_kernels.py: GQA, sliding window,
softcap, sk > sq, narrow windows, head_dim 24, bf16, ragged q).  The CUDA
kernel itself runs only on a card (tests/test_torch_card.py).

Tolerances: float32 atol 2e-5 (the reference's own for its kernel), bf16
atol 3e-2 (the reference's bf16 tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops, ref as jref
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_ATOL = 3e-2

# b, h, kv, sq, sk, hd, causal, window, softcap, bq, bk (the reference's)
CASES = [
    (1, 4, 2, 128, 128, 64, True, None, None, 64, 64),
    (2, 4, 4, 256, 256, 32, True, None, None, 128, 128),
    (1, 8, 2, 128, 128, 64, True, 64, None, 64, 64),     # GQA 4x + SWA
    (1, 2, 1, 128, 256, 64, True, None, 50.0, 64, 64),   # softcap, sk > sq
    (1, 2, 2, 192, 192, 16, True, 32, None, 64, 64),     # narrow window
    (1, 1, 1, 64, 64, 24, True, None, None, 32, 32),     # hd 24
]


def _qkv(b, h, kv, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


def _t(a):
    return torch.from_numpy(a)


def _bhsd(a):
    return a.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_jax_oracle(case):
    b, h, kv, sq, sk, hd, causal, win, cap, _, _ = case
    q, k, v = _qkv(b, h, kv, sq, sk, hd, seed=sq + hd)
    kw = dict(causal=causal, sliding_window=win, softcap=cap)
    got = ref.attention_ref(_t(_bhsd(q)), _t(_bhsd(k)), _t(_bhsd(v)), **kw)
    want = jref.attention_ref(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                              jnp.asarray(_bhsd(v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_wrapper_matches_the_jax_kernel_in_interpret_mode(case):
    b, h, kv, sq, sk, hd, causal, win, cap, bq, bk = case
    q, k, v = _qkv(b, h, kv, sq, sk, hd, seed=7 * sq + hd)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              sliding_window=win, softcap=cap)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                sliding_window=win, softcap=cap,
                                block_q=bq, block_k=bk, interpret=True)
    assert tuple(got.shape) == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


def test_bf16_matches_the_jax_float32_oracle():
    q, k, v = _qkv(1, 2, 2, 128, 128, 32, seed=11)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = jref.attention_ref(*(jnp.asarray(_bhsd(t.float().numpy()))
                                for t in (qb, kb, vb)))
    np.testing.assert_allclose(got.float().numpy(),
                               _bhsd(np.asarray(want)), atol=BF16_ATOL)


def test_ragged_q_needs_no_padding():
    """Sq = Sk = 100 is a multiple of no block: the reference pads, the
    port's wrapper takes it as it is."""
    q, k, v = _qkv(1, 2, 1, 100, 100, 32, seed=12)
    got = ops.flash_attention(_t(q), _t(k), _t(v))
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=64, block_k=50,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)


@pytest.mark.parametrize("sk", [128, 130])
def test_bidirectional_matches_the_oracle_even_for_a_ragged_sk(sk):
    """The reference's wrapper refuses a ragged Sk without causal masking
    (its padding would leak); the port masks it, so only the oracle is
    compared there."""
    q, k, v = _qkv(1, 4, 2, 77, sk, 80, seed=sk)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    want = jref.attention_ref(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                              jnp.asarray(_bhsd(v)), causal=False)
    np.testing.assert_allclose(got.numpy(), _bhsd(np.asarray(want)),
                               atol=F32_ATOL)


def test_a_row_with_no_key_gives_zero():
    """Bidirectional with a window and Sq > Sk + window: the last queries
    see no key.  The TPU kernel (and the CUDA kernel) give 0 there."""
    q, k, v = _qkv(1, 2, 2, 40, 8, 16, seed=13)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                              sliding_window=4)
    ok = ref.mask(40, 8, causal=False, sliding_window=4)
    dead = ~ok.any(dim=-1)
    assert dead.any() and not dead.all()
    assert torch.equal(got[0, dead], torch.zeros_like(got[0, dead]))
    want = jref.attention_ref(jnp.asarray(_bhsd(q)), jnp.asarray(_bhsd(k)),
                              jnp.asarray(_bhsd(v)), causal=False,
                              sliding_window=4)
    live = (~dead).numpy()
    np.testing.assert_allclose(got[0, live].numpy(),
                               _bhsd(np.asarray(want))[0, live],
                               atol=F32_ATOL)


def test_wrapper_on_the_cpu_counts_nothing_and_refuses_other_devices():
    q, k, v = _qkv(1, 2, 1, 16, 16, 8, seed=14)
    before = ops.launches
    ops.flash_attention(_t(q), _t(k), _t(v))
    assert ops.launches == before
    meta = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="not on meta"):
        ops.flash_attention(meta, meta, meta)
