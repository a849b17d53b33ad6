"""Tests of the port that need a CUDA card: the hand-written kernels
(fused_step, RMSNorm, flash attention) against their plain versions on the
card, their operand checks, the resident logistic-regression path through
fused_step, and a served model through RMSNorm and flash.  They skip, with
the reason, where there is no card.  This file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_update import kernel, ops, ref
from repro_torch.kernels.rmsnorm import ops as rn_ops, ref as rn_ref
from repro_torch.models import transformer
from repro_torch.serve.engine import ResidentEngine
from repro_torch.serve.scheduler import ContinuousBatcher, Request

# the kernel on the card vs the plain version on the card: FMAs in k order
# vs cuBLAS's order over the m mix terms of O(1) magnitude
CARD_RTOL = 1e-5
CARD_ATOL = 1e-5
# whole runs, card vs CPU: float32 summed in different orders, compounded
HISTORY_RTOL = 1e-4
HISTORY_ATOL = 1e-6
# RMSNorm and flash on the card vs their plain versions on the card, as
# chip_smoke.py derives them: float32, other summation orders (2e-5 is the
# reference's own flash tolerance); bf16 RMSNorm one bf16 ulp (2^-7 of the
# value); bf16 flash against the float32 plain version of the same inputs,
# the output's rounding to bf16 (2^-8 of the value) on top of float32's
RMS_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=8e-3, atol=1e-5)}
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=4e-3, atol=2e-5)}
# model logits, kernel routes vs plain routes on the card (smoke size)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused_step kernel is CUDA C++ "
                    "for sm_90a and has no CPU or interpret mode")
    return torch.device("cuda")


def _case(m, d, rule, seed, device):
    rng = np.random.default_rng(seed)
    n = 4 if rule == "svrg" else 2
    streams = [torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                               device=device) for _ in range(n)]
    w = graphs.b_connected_ring_schedule(m, 2, seed=seed).consensus_rounds(
        0, 3)
    return torch.as_tensor(w, dtype=torch.float32, device=device), streams


@pytest.mark.parametrize("m,d", [(8, 1024), (8, 1000), (32, 4096), (3, 7),
                                 (64, 300)])
@pytest.mark.parametrize("prox_kind", ref.FUSED_PROXES)
@pytest.mark.parametrize("rule", ref.FUSED_RULES)
def test_kernel_matches_plain_version_on_card(cuda_device, rule, prox_kind,
                                              m, d):
    w, streams = _case(m, d, rule, m * d, cuda_device)
    before = ops.launches
    got = ops.fused_step_buf(w, streams, 0.05, 0.01, rule=rule,
                             prox_kind=prox_kind)
    assert ops.launches == before + 1
    want = ref.fused_step_math(w, streams, 0.05, 0.01, rule=rule,
                               prox_kind=prox_kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)
    # alpha read from device memory gives the same bits as alpha by value
    alpha = torch.tensor([0.05], dtype=torch.float32, device=cuda_device)
    assert torch.equal(ops.fused_step_buf(w, streams, alpha[0], 0.01,
                                          rule=rule, prox_kind=prox_kind),
                       got)


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    m_max = kernel.max_m()
    before = ops.launches
    w = torch.eye(m_max + 1, device=cuda_device)
    big = [torch.zeros(m_max + 1, 16, device=cuda_device) for _ in range(2)]
    with pytest.raises(ValueError, match="at most"):
        ops.fused_step_buf(w, big, 0.1, 0.01, rule="sgd")
    w = torch.eye(4, device=cuda_device)
    doubles = [torch.zeros(4, 8, device=cuda_device, dtype=torch.float64)] * 2
    with pytest.raises(TypeError, match="float32"):
        ops.fused_step_buf(w.double(), doubles, 0.1, 0.01, rule="sgd")
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_step_buf(w, [torch.zeros(8, 4, device=cuda_device).t()] * 2,
                           0.1, 0.01, rule="sgd")
    with pytest.raises(ValueError, match="takes 4 streams"):
        ops.fused_step_buf(w, [torch.zeros(4, 8, device=cuda_device)] * 2,
                           0.1, 0.01, rule="svrg")
    with pytest.raises(ValueError, match="operands on"):
        ops.fused_step_buf(w.cpu(), [torch.zeros(4, 8, device=cuda_device)] * 2,
                           0.1, 0.01, rule="sgd")
    assert ops.launches == before


def _loss(w, batch):
    z = batch["features"] @ w
    return torch.mean(-batch["labels"] * z + torch.log1p(torch.exp(z)))


def _runs(device):
    ds = synthetic.make_paper_dataset("adult_like", scale=0.05)
    data = params_from_numpy(synthetic.partition_per_node(ds, 8), device)
    x0 = torch.zeros(8, ds.dim, device=device)
    problem = algorithm.Problem(_loss, prox.l1(0.01), x0, data)
    sched = graphs.b_connected_ring_schedule(8, 2)
    spec = ExecSpec(resident=True, kernel="fused", gossip="dense",
                    device=device)
    dp = algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=0.2, beta=1.2, n0=4, num_outer=6))
    steps = sum(dp.meta.outer_lengths)
    ds_algo = algorithm.dspg_algorithm(
        problem, algorithm.DSPGHyperParams(alpha0=0.2), steps)
    out = []
    for algo, every in ((dp, 0), (ds_algo, 10)):
        before = ops.launches
        res = runner.run(algo, problem, sched, spec, record_every=every)
        out.append((res, ops.launches - before, steps))
    return out


def test_resident_main_path_on_card_matches_cpu(cuda_device):
    """DPSVRG and DSPG through the kernel: one launch per inner step, and
    the same histories as the port on the CPU."""
    for (res, launches, steps), (cpu, cpu_launches, _) in zip(
            _runs("cuda"), _runs("cpu")):
        assert launches == steps and cpu_launches == 0
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(getattr(res.history, col),
                                       getattr(cpu.history, col),
                                       rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
        np.testing.assert_array_equal(res.history.steps, cpu.history.steps)
        assert res.extras["transfers_h2d"] == cpu.extras["transfers_h2d"]


# ---------------------------------------------------------------------------
# RMSNorm and flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 128), (3, 2560), (8, 100),
                                    (517, 2560), (2, 20000)])
def test_rmsnorm_kernel_matches_plain_version_on_card(cuda_device, rows, d,
                                                      dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows * d)
    x = torch.randn(rows, d, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(dtype)
    before = rn_ops.launches
    got = rn_ops.rmsnorm(x, w)
    assert rn_ops.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, rn_ref.rmsnorm_ref(x, w), **RMS_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_strided_rows(cuda_device, dtype):
    x = torch.randn(3, 9, 256, device=cuda_device).to(dtype)
    w = torch.randn(256, device=cuda_device).to(dtype)
    torch.testing.assert_close(rn_ops.rmsnorm(x[:, -1:], w),
                               rn_ref.rmsnorm_ref(x[:, -1:], w),
                               **RMS_TOL[dtype])


def test_rmsnorm_kernel_rejects_what_it_does_not_take(cuda_device):
    before = rn_ops.launches
    x = torch.zeros(4, 8, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rn_ops.rmsnorm(x.double(), torch.zeros(8, device=cuda_device))
    with pytest.raises(TypeError, match="weight of x's dtype"):
        rn_ops.rmsnorm(x.to(torch.bfloat16),
                       torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="weight shape"):
        rn_ops.rmsnorm(x, torch.zeros(7, device=cuda_device))
    with pytest.raises(ValueError, match="operands on"):
        rn_ops.rmsnorm(x, torch.zeros(8))
    with pytest.raises(ValueError, match="unit column stride"):
        rn_ops.rmsnorm(torch.zeros(8, 4, device=cuda_device).t(),
                       torch.zeros(8, device=cuda_device))
    assert rn_ops.launches == before


FLASH_CARD_CASES = [
    # b, h, kv, sq, sk, hd, causal, window, softcap
    (1, 4, 2, 128, 128, 64, True, None, None),
    (2, 4, 4, 256, 256, 32, True, None, None),
    (1, 8, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 128, 256, 64, True, None, 50.0),
    (1, 2, 2, 192, 192, 16, True, 32, None),
    (1, 1, 1, 64, 64, 24, True, None, None),
    (1, 4, 2, 100, 100, 80, True, None, None),
    (1, 4, 2, 77, 130, 80, False, None, None),
    (1, 4, 4, 200, 200, 128, False, 37, None),
    (1, 4, 2, 300, 300, 256, True, 100, 50.0),
    (1, 6, 3, 65, 65, 160, True, 20, 30.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES)
def test_flash_kernel_matches_plain_version_on_card(cuda_device, case,
                                                    dtype):
    b, h, kv, sq, sk, hd, causal, win, cap = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq * hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                           device=cuda_device).to(dtype)
               for s, n in ((sq, h), (sk, kv), (sk, kv)))
    kw = dict(causal=causal, sliding_window=win, softcap=cap)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches == before + 1
    want = fa_ref.attention_ref(*(t.float().transpose(1, 2)
                                  for t in (q, k, v)), **kw).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, **FLASH_TOL[dtype])


def test_flash_kernel_gives_zero_for_a_row_with_no_key(cuda_device):
    q = torch.randn(1, 40, 2, 16, device=cuda_device)
    k = torch.randn(1, 8, 2, 16, device=cuda_device)
    v = torch.randn(1, 8, 2, 16, device=cuda_device)
    kw = dict(causal=False, sliding_window=4)
    torch.testing.assert_close(
        fa_ops.flash_attention(q, k, v, **kw),
        fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2),
        **FLASH_TOL[torch.float32])


def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    before = fa_ops.launches
    q = torch.zeros(1, 8, 4, 16, device=cuda_device)
    k = torch.zeros(1, 8, 3, 16, device=cuda_device)
    with pytest.raises(ValueError, match="do not split"):
        fa_ops.flash_attention(q, k, k)
    k = torch.zeros(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(TypeError, match="q is"):
        fa_ops.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2), k, k)
    big = torch.zeros(1, 8, 2, 264, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim up to"):
        fa_ops.flash_attention(big, big, big)
    assert fa_ops.launches == before


# ---------------------------------------------------------------------------
# a served model through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-9b",
                                  "minicpm-2b"])
def test_model_kernel_routes_match_plain_routes_on_card(cuda_device, arch):
    """Smoke size, a prompt longer than the window of 16: every norm is one
    RMSNorm launch, every prefill layer one flash launch, and the logits
    match the plain routes."""
    cfg = configs.smoke_variant(configs.get_config(arch))
    kcfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda_device)
    norms = (4 if cfg.post_norm else 2) * cfg.num_layers + 1
    rn_ops.launches = fa_ops.launches = 0
    lk, ck = transformer.prefill(kcfg, params, toks, max_len=64)
    assert (fa_ops.launches, rn_ops.launches) == (cfg.num_layers, norms)
    lp, cp = transformer.prefill(cfg, params, toks, max_len=64)
    torch.testing.assert_close(lk, lp, **LOGIT_TOL)
    cur = lp.argmax(-1).to(torch.int32)
    for _ in range(3):
        lk, ck = transformer.decode_step(kcfg, params, ck, cur)
        lp, cp = transformer.decode_step(cfg, params, cp, cur)
        torch.testing.assert_close(lk, lp, **LOGIT_TOL)
        cur = lp.argmax(-1).to(torch.int32)
    assert fa_ops.launches == cfg.num_layers


def test_resident_engine_on_card_matches_host_batcher(cuda_device):
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b")).scaled(
        use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=int(rng.integers(2, 9)))
            for i, n in enumerate((5, 12, 20, 33, 7))]
    eng = ResidentEngine(cfg, params, max_slots=2, max_len=64, chunk=4)
    host = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    for r in reqs:
        eng.submit(r)
        host.submit(r)
    eout, hout = eng.run_until_done(), host.run_until_done()
    for r in reqs:
        np.testing.assert_array_equal(eout[r.uid], hout[r.uid])
    assert eng.transfers["h2d"] == len(reqs)
    assert eng.transfers["d2h"] == eng.transfers["chunks"]
