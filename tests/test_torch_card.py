"""Tests of the port that need a CUDA card: the hand-written fused_step
kernel against its plain version on the card, its operand checks, and the
resident main path through it.  They skip, with the reason, where there is
no card.  This file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
from repro_torch.kernels.fused_update import kernel, ops, ref

# the kernel on the card vs the plain version on the card: FMAs in k order
# vs cuBLAS's order over the m mix terms of O(1) magnitude
CARD_RTOL = 1e-5
CARD_ATOL = 1e-5
# whole runs, card vs CPU: float32 summed in different orders, compounded
HISTORY_RTOL = 1e-4
HISTORY_ATOL = 1e-6


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
