"""The port's flash attention kernel package
(``repro_torch.kernels.flash_attention``) on the CPU: its plain version and
its wrapper against the JAX package's oracle (``attention_ref``) and its
Pallas kernel in interpret mode (``ops.flash_attention``), over the
reference's own variant sweep (tests/test_kernels.py: GQA, sliding window,
softcap, sk > sq, narrow windows, head_dim 24, bf16, ragged q).  The CUDA
kernel itself runs only on a card (tests/test_torch_card.py).

Tolerances: float32 atol 2e-5 (the reference's own for its kernel), bf16
atol 3e-2 (the reference's bf16 tolerance).  The card's bf16 check,
``ref.bf16_bound``, is derived from where the bf16 kernel rounds; the last
tests emulate that arithmetic on the CPU over every shape of the card tests
(tests/test_torch_card.py:FLASH_CARD_CASES) and hold it to the bound.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops, ref as jref
from repro_torch.kernels.flash_attention import ops, ref
from test_torch_card import FLASH_CARD_CASES

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


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic and its bound
# ---------------------------------------------------------------------------

# the check of the bf16 kernel before the bound: the output's rounding only
OLD_BF16_TOL = dict(rtol=4e-3, atol=2e-5)


def _emulate_bf16_kernel(q, k, v, *, causal, sliding_window, softcap,
                         block_k=64):
    """The bf16 kernel's arithmetic in plain PyTorch, q: (B, H, Sq, hd), k,
    v: (B, KV, Sk, hd), bf16: float32 scores of the bf16 values, an online
    softmax over tiles of 64 keys with m, l and the accumulator in float32,
    P rounded to bf16 before P V (l sums the unrounded p), and the output
    rounded once to bf16."""
    b, h, sq, hd = q.shape
    sk = k.shape[2]
    kf, vf = (t.float().repeat_interleave(h // k.shape[1], dim=1)
              for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(hd)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = ref.mask(sq, sk, causal=causal, sliding_window=sliding_window)
    s = torch.where(ok, s, torch.full_like(s, -1e30))
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    for k0 in range(0, sk, block_k):
        tile = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, tile.amax(dim=-1))
        alpha = torch.where(m > -5e29, torch.exp(m - m_new),
                            torch.zeros_like(m))
        p = torch.where((m_new > -5e29)[..., None],
                        torch.exp(tile - m_new[..., None]),
                        torch.zeros_like(tile))
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _bf16_case(case, seed):
    b, h, kv, sq, sk, hd, causal, win, cap = case
    q, k, v = _qkv(b, h, kv, sq, sk, hd, seed=seed)
    qb, kb, vb = (_t(_bhsd(a)).to(torch.bfloat16) for a in (q, k, v))
    return qb, kb, vb, dict(causal=causal, sliding_window=win, softcap=cap)


@pytest.mark.parametrize("case", FLASH_CARD_CASES)
def test_bf16_kernel_arithmetic_stays_within_the_bound(case):
    """The emulated kernel is within ref.bf16_bound of the plain version on
    every card shape, and the bound's plain version is the JAX oracle on
    the float32 values of the same inputs."""
    qb, kb, vb, kw = _bf16_case(case, seed=sum(case[:6]))
    plain, bound = ref.bf16_bound(qb, kb, vb, **kw)
    want = jref.attention_ref(*(jnp.asarray(t.float().numpy())
                                for t in (qb, kb, vb)), **kw)
    dead = ~ref.mask(qb.shape[2], kb.shape[2], causal=kw["causal"],
                     sliding_window=kw["sliding_window"]).any(dim=-1)
    live = (~dead).numpy()
    np.testing.assert_allclose(plain.numpy()[:, :, live],
                               np.asarray(want)[:, :, live], atol=F32_ATOL)
    err = (_emulate_bf16_kernel(qb, kb, vb, **kw).float() - plain).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def test_the_old_bf16_tolerance_is_not_enough_for_the_kernel_arithmetic():
    """rtol 4e-3 / atol 2e-5 covers the output's rounding only; rounding P
    to bf16 breaks it on some card shape, hence ref.bf16_bound."""
    broken = []
    for case in FLASH_CARD_CASES:
        qb, kb, vb, kw = _bf16_case(case, seed=sum(case[:6]))
        plain, _ = ref.bf16_bound(qb, kb, vb, **kw)
        got = _emulate_bf16_kernel(qb, kb, vb, **kw).float()
        if not torch.allclose(got, plain, **OLD_BF16_TOL):
            broken.append(case)
    assert broken
