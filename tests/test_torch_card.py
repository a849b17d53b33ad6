"""Tests of the port that need a CUDA card: the hand-written kernels
(fused_step, svrg_step, mix_prox, RMSNorm, flash attention) against their
plain versions on the card, their operand checks, the resident
logistic-regression path through fused_step (dense and banded gossip), its
CUDA graph replays against the eager executor, the kernel bench, and a
served model through RMSNorm and flash.  They skip, with
the reason, where there is no card.  This file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_card.py
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import pt_kernel_bench  # noqa: E402
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, graphs, prox, runner
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_update import kernel, ops, ref
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
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
# value).  bf16 flash is held element by element to fa_ref.bf16_bound
# against the float32 plain version of the same inputs: the kernel rounds
# P to bf16 before P V and its output to bf16.
RMS_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=8e-3, atol=1e-5)}
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-5)
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


# the layouts of the redesigned kernel: m as a template parameter (8, 16)
# and at run time (64); the 16-byte vector path (d % 4 == 0, aligned
# buffers) and the scalar path (ragged d, or views one element into their
# buffers)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [1, 7, 30, 1000, 1024, 1031, 8192])
@pytest.mark.parametrize("m", [8, 16, 64])
def test_kernel_layouts_match_plain_version_on_card(cuda_device, m, d,
                                                    offset):
    alpha = torch.tensor([0.05], dtype=torch.float32, device=cuda_device)
    for rule in ref.FUSED_RULES:
        w, streams = _case(m, d, rule, m * d + offset, cuda_device)
        if offset:
            streams = [torch.cat([s.new_zeros(1), s.reshape(-1)])[1:]
                       .view(m, d) for s in streams]
        for prox_kind in ref.FUSED_PROXES:
            before = ops.launches
            got = ops.fused_step_buf(w, streams, alpha[0], 0.01, rule=rule,
                                     prox_kind=prox_kind)
            assert ops.launches == before + 1
            want = ref.fused_step_math(w, streams, alpha[0], 0.01, rule=rule,
                                       prox_kind=prox_kind)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=CARD_RTOL,
                                       atol=CARD_ATOL)


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


def _algo(name, problem):
    return {
        "dpsvrg": lambda: algorithm.dpsvrg_algorithm(
            problem, algorithm.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4,
                                                 num_outer=6)),
        "dspg": lambda: algorithm.dspg_algorithm(
            problem, algorithm.DSPGHyperParams(alpha0=0.2), 150),
        "loopless_dpsvrg": lambda: algorithm.loopless_dpsvrg_algorithm(
            problem, 0.2, 60, snapshot_prob=0.1),
        "dvr": lambda: algorithm.dvr_algorithm(problem, 0.2, 60, rho=0.6,
                                               snapshot_prob=0.1),
        "dpg": lambda: algorithm.dpg_algorithm(problem, 0.2, 30),
        "gt_svrg": lambda: algorithm.gt_svrg_algorithm(
            problem, 0.05, num_outer=3, inner_steps=10),
    }[name]()


GRAPH_CASES = [(name, gossip, transitions)
               for name in ("dpsvrg", "dspg", "loopless_dpsvrg", "dvr", "dpg",
                            "gt_svrg")
               for gossip in ("dense", "banded", "compressed")
               for transitions in ("auto", False)
               # DSPG and DPG thread no mix state: no compressed run
               if not (name in ("dspg", "dpg") and gossip == "compressed")]


@pytest.mark.parametrize("name,gossip,transitions", GRAPH_CASES)
def test_graph_replay_matches_eager_execution_on_card(cuda_device,
                                                      monkeypatch, name,
                                                      gossip, transitions):
    """Every resident run on the card replays CUDA graphs of its pieces:
    at most ceil(log2(longest chunk)) + 1 of them, the launch counts exact
    under replay, and the histories those of the eager executor."""
    ds = synthetic.make_paper_dataset("adult_like", scale=0.05)
    data = params_from_numpy(synthetic.partition_per_node(ds, 8), "cuda")
    problem = algorithm.Problem(_loss, prox.l1(0.01),
                                torch.zeros(8, ds.dim, device="cuda"), data)
    sched = graphs.b_connected_ring_schedule(8, 1)
    every = 0 if name == "dpsvrg" else 10
    spec = ExecSpec(resident=True, kernel="fused", gossip=gossip,
                    device_transitions=transitions)

    def run():
        before = ops.launches
        res = runner.run(_algo(name, problem), problem, sched, spec,
                         record_every=every)
        torch.cuda.synchronize()
        return res, ops.launches - before

    graph, graph_launches = run()
    monkeypatch.setattr(runner, "CUDA_GRAPHS", False)
    eager, eager_launches = run()
    steps = int(graph.history.steps[-1])
    fused = gossip != "compressed" and name != "gt_svrg"
    assert graph_launches == eager_launches == (steps if fused else 0)
    meta = _algo(name, problem).meta
    longest = (max(meta.outer_lengths) if meta.outer_lengths is not None
               else meta.num_steps)
    longest = min(longest, every) if every else longest
    assert 1 <= graph.extras["graphs_built"] <= \
        math.ceil(math.log2(longest)) + 1
    assert graph.extras["replays"] >= graph.extras["graphs_built"]
    assert eager.extras["graphs_built"] == eager.extras["replays"] == 0
    assert (graph.extras["transfers_h2d"],
            graph.extras["transfers_d2h"]) == (1, 1)
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(graph.history, col),
                                   getattr(eager.history, col),
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    np.testing.assert_allclose(graph.params.cpu().numpy(),
                               eager.params.cpu().numpy(),
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


# ---------------------------------------------------------------------------
# svrg_step and mix_prox: equal to their plain versions bit for bit
# ---------------------------------------------------------------------------

def _flat(n, count, seed, device, offset=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=n + offset), dtype=torch.float32,
                            device=device)[offset:] for _ in range(count)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 7, 1000, 8 * 1024, 300_001])
def test_svrg_step_kernel_equals_plain_version_on_card(cuda_device, n,
                                                       offset):
    x, gn, gs, mu = _flat(n, 4, n, cuda_device, offset)
    for alpha in (0.0, 0.05, 1.0):
        want = ref.svrg_step_ref(x, gn, gs, mu, alpha)
        dev = torch.tensor([alpha], dtype=torch.float32, device=cuda_device)
        for a in (alpha, dev[0]):
            before = ops.launches_svrg_step
            got = ops.svrg_step(x, gn, gs, mu, a)
            assert ops.launches_svrg_step == before + 1
            assert torch.equal(got, want)


@pytest.mark.parametrize("case", [(1.0, 0.0, 0.0, 0.0),
                                  (1 / 3, 1 / 3, 1 / 3, 0.01),
                                  (0.5, 0.25, 0.25, 0.3)])
@pytest.mark.parametrize("n,offset", [(7, 0), (1000, 1), (8 * 1024, 0),
                                      (300_001, 1)])
def test_mix_prox_kernel_equals_plain_version_on_card(cuda_device, n,
                                                      offset, case):
    qs, qu, qd = _flat(n, 3, n + 1, cuda_device, offset)
    before = ops.launches_mix_prox
    got = ops.mix_prox(qs, qu, qd, *case)
    assert ops.launches_mix_prox == before + 1
    assert torch.equal(got, ref.mix_prox_ref(qs, qu, qd, *case))


def test_svrg_mix_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(4, 8, device=cuda_device)
    before = (ops.launches_svrg_step, ops.launches_mix_prox)
    with pytest.raises(TypeError, match="float32"):
        ops.svrg_step(*[x.double()] * 4, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mix_prox(*[x.t()] * 3, 1.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="shapes"):
        ops.svrg_step(x, x, x, torch.zeros(8, 4, device=cuda_device), 0.1)
    with pytest.raises(ValueError, match="operands on"):
        ops.mix_prox(x, x.cpu(), x, 1.0, 0.0, 0.0, 0.0)
    with pytest.raises(ValueError, match="alpha"):
        ops.svrg_step(x, x, x, x, torch.tensor([0.1, 0.2],
                                               device=cuda_device))
    with pytest.raises(ValueError, match="alpha"):
        ops.svrg_step(x, x, x, x, torch.tensor(0.1))
    assert (ops.launches_svrg_step, ops.launches_mix_prox) == before


def test_kernel_bench_on_card_launches_what_it_calls(cuda_device):
    """The bench's kernel rows launch exactly the calls they record, and the
    banded large-d fused run launches fused_step once per inner step; its
    histories equal the bench run on the CPU."""
    kw = dict(large_d=2048, paper_steps=100)
    before = (ops.launches_svrg_step, ops.launches_mix_prox)
    rows = pt_kernel_bench.run(0.02, "cuda", rows=64, **kw)
    calls = {"svrg_step": 0, "mix_prox": 0}
    for r in rows:
        for k, v in r.data.get("calls", {}).items():
            calls[k] += v
    assert (ops.launches_svrg_step - before[0],
            ops.launches_mix_prox - before[1]) == (calls["svrg_step"],
                                                   calls["mix_prox"])
    by_name = {r.name: r.data for r in rows}
    assert set(by_name["kernel/svrg_mix_check"]["max_abs_err"].values()) \
        == {0.0}
    cpu = pt_kernel_bench.kernel_stats(0.02, "cpu", timed=False, **kw)
    for row, key in (("kernel/resident_paper_scale_auto", "paper_scale"),
                     ("kernel/resident_large_d_fused", "large_d")):
        sec = by_name[row]
        assert sec["fused_launches"] == sec["steps"]
        for kind, hist in sec["objective"].items():
            np.testing.assert_allclose(hist, cpu[key]["objective"][kind],
                                       rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


@pytest.mark.parametrize("name", ["loopless_dpsvrg", "dvr", "dpg"])
def test_banded_fused_runs_on_card_match_cpu(cuda_device, name):
    """The banded phi reaches the kernel (one launch per step) for every
    method with a fused twin, and the card's history equals the CPU's."""
    sched = pt_kernel_bench._circulant8()

    def run(device):
        problem = pt_kernel_bench.large_problem(device, 1024)
        algo = {"loopless_dpsvrg": lambda: algorithm.loopless_dpsvrg_algorithm(
                    problem, 0.05, 30, snapshot_prob=0.2,
                    consensus_rounds=1),
                "dvr": lambda: algorithm.dvr_algorithm(
                    problem, 0.05, 30, snapshot_prob=0.2),
                "dpg": lambda: algorithm.dpg_algorithm(problem, 0.05, 30),
                }[name]()
        before = ops.launches
        res = runner.run(algo, problem, sched,
                         ExecSpec(resident=True, kernel="fused",
                                  gossip="banded", device=device),
                         record_every=10)
        return res, ops.launches - before

    res, launches = run("cuda")
    cpu, cpu_launches = run("cpu")
    assert launches == 30 and cpu_launches == 0
    np.testing.assert_allclose(res.history.objective, cpu.history.objective,
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    np.testing.assert_array_equal(res.extras["wire_bytes"],
                                  cpu.extras["wire_bytes"])


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


# the row widths around the kernel's register tiles: the models' widths
# (minicpm 2304, h2o-danube 2560, gemma2 3584, the smoke variants 128), a
# ragged d (1, 7: the scalar two-pass path), one vector of float32 (4) or
# one bf16 vector (8), the widest rows of the two-warp tile of 4 vectors a
# lane (1024 float32, 2048 bf16), and by name the widest row held in
# registers, the first one past it (two passes) and the widest the kernel
# takes
RMS_EDGE_DIMS = [1, 7, 8, 128, 1024, 2048, 2304, 2560, 3584, "register",
                 "register+8", "max"]


def _rms_width(d, dtype):
    if d == "register":
        return rn_kernel.max_register_d(dtype)
    if d == "register+8":
        return rn_kernel.max_register_d(dtype) + 8
    if d == "max":
        return rn_kernel.max_d(dtype)
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 133, 6144])
@pytest.mark.parametrize("d", RMS_EDGE_DIMS)
def test_rmsnorm_kernel_matches_plain_version_at_the_tile_edges(
        cuda_device, d, rows, dtype):
    d = _rms_width(d, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(rows + d)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2304, 2560, 3584])
def test_rmsnorm_kernel_takes_strided_and_misaligned_rows_of_model_width(
        cuda_device, d, dtype):
    """x[:, -1] of a (B, L, d) batch read in place (the register tiles), and
    rows that start one element into a buffer (not 16-byte aligned: the
    scalar two-pass path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(5, 3, d, generator=gen, device=cuda_device).to(dtype)
    w = (0.1 * torch.randn(d, generator=gen, device=cuda_device)).to(dtype)
    torch.testing.assert_close(rn_ops.rmsnorm(x[:, -1], w),
                               rn_ref.rmsnorm_ref(x[:, -1], w),
                               **RMS_TOL[dtype])
    flat = torch.randn(133 * d + 1, generator=gen, device=cuda_device)
    odd = flat.to(dtype)[1:].view(133, d)
    assert odd.data_ptr() % 16 != 0
    torch.testing.assert_close(rn_ops.rmsnorm(odd, w),
                               rn_ref.rmsnorm_ref(odd, w), **RMS_TOL[dtype])


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
    # the bf16 kernel's edges: 128-row q tiles, 64-key tiles, hd_pad 16 k
    (1, 2, 1, 1024, 1024, 80, True, 128, None),     # window empties tiles
    (1, 8, 2, 200, 200, 80, True, None, 30.0),      # softcap, GQA 4x
    (2, 4, 1, 130, 130, 80, True, 64, None),        # B = 2, GQA 4x, ragged
    (1, 2, 2, 33, 130, 16, False, None, None),      # Sq < BQ, Sk % 64 != 0
    (1, 2, 1, 129, 257, 24, True, None, None),      # hd 24 -> 32, sk > sq
    (1, 2, 2, 140, 140, 160, False, 70, None),      # hd 160, bidirectional
    (1, 2, 1, 256, 256, 256, True, None, None),     # hd 256, two q tiles
    (1, 2, 1, 70, 70, 13, True, None, None),        # odd hd, hd % 8 != 0
]


# the float32 kernel's edges: hd_pad = round_up(hd, 16) buckets (1, 3, 33
# and 255 take ordinary loads: hd % 4 != 0), 128-row q blocks (64 above
# hd_pad 128), kv tiles of 64 keys (32 above hd_pad 112), GQA 1/2/4/8, a
# window narrower than a tile, the softcap
FLASH_F32_CARD_CASES = [
    (1, 2, 2, 130, 130, 1, True, None, None),       # hd 1, GQA 1
    (1, 4, 2, 97, 97, 3, True, None, None),         # hd 3
    (1, 4, 1, 129, 161, 4, True, None, None),       # hd 4, GQA 4, sk > sq
    (1, 8, 1, 200, 200, 33, True, None, None),      # hd 33, GQA 8
    (2, 8, 1, 150, 150, 64, True, 20, None),        # window 20 < 64 keys
    (1, 4, 2, 257, 257, 80, True, None, 30.0),      # softcap, two q blocks
    (1, 4, 2, 300, 300, 80, True, 4096, None),      # danube's shape, short
    (1, 4, 4, 131, 95, 96, False, None, None),      # bidirectional, sk < sq
    (1, 4, 2, 140, 140, 128, True, 48, None),       # hd 128, 128-row block
    (1, 2, 1, 70, 70, 255, True, None, None),       # hd 255, 64-row block
    (1, 2, 2, 65, 200, 256, False, 17, 20.0),       # hd 256, narrow window
]


def _flash_check(got, q, k, v, kw):
    """got against the plain version on the float32 values of q, k, v:
    float32 at FLASH_F32_TOL, bf16 within fa_ref.bf16_bound."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if q.dtype == torch.float32:
        want = fa_ref.attention_ref(qt, kt, vt, **kw).transpose(1, 2)
        torch.testing.assert_close(got, want, **FLASH_F32_TOL)
        return
    plain, bound = fa_ref.bf16_bound(qt, kt, vt, **kw)
    err = (got.float() - plain.transpose(1, 2)).abs()
    excess = float((err - bound.transpose(1, 2)).max())
    assert excess <= 0, (f"bf16 flash exceeds its bound by {excess:.3g} "
                         f"(max abs err {float(err.max()):.3g})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES)
def test_flash_kernel_matches_plain_version_on_card(cuda_device, case,
                                                    dtype):
    _flash_case(cuda_device, case, dtype)


def _flash_case(cuda_device, case, dtype):
    """One launch on the case's seeded inputs, held by _flash_check."""
    b, h, kv, sq, sk, hd, causal, win, cap = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq * hd)
    q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                           device=cuda_device).to(dtype)
               for s, n in ((sq, h), (sk, kv), (sk, kv)))
    kw = dict(causal=causal, sliding_window=win, softcap=cap)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _flash_check(got, q, k, v, kw)


@pytest.mark.parametrize("case", FLASH_F32_CARD_CASES)
def test_flash_f32_kernel_matches_plain_version_at_its_tile_edges(
        cuda_device, case):
    _flash_case(cuda_device, case, torch.float32)


@pytest.mark.parametrize("hd", [16, 80, 256])
def test_flash_f32_kernel_gives_zero_for_rows_with_no_key(cuda_device, hd):
    """Bidirectional with a window: rows past Sk + window - 1 keep no key;
    they span whole q blocks and kv tiles."""
    q, k, v = (torch.randn(1, s, 4, hd, device=cuda_device)
               for s in (300, 40, 40))
    kw = dict(causal=False, sliding_window=10)
    got = fa_ops.flash_attention(q, k, v, **kw)
    dead = ~fa_ref.mask(300, 40, causal=False, sliding_window=10,
                        device=cuda_device).any(dim=-1)
    assert int(dead.sum()) == 300 - 49
    assert torch.equal(got[0, dead], torch.zeros_like(got[0, dead]))
    _flash_check(got, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_gives_zero_for_a_row_with_no_key(cuda_device, dtype):
    q, k, v = (torch.randn(1, s, 2, 16, device=cuda_device).to(dtype)
               for s in (40, 8, 8))
    kw = dict(causal=False, sliding_window=4)
    got = fa_ops.flash_attention(q, k, v, **kw)
    dead = ~fa_ref.mask(40, 8, causal=False, sliding_window=4,
                        device=cuda_device).any(dim=-1)
    assert dead.any() and torch.equal(got[0, dead],
                                      torch.zeros_like(got[0, dead]))
    _flash_check(got, q, k, v, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device, dtype):
    before = fa_ops.launches
    q = torch.zeros(1, 8, 4, 16, device=cuda_device, dtype=dtype)
    k = torch.zeros(1, 8, 3, 16, device=cuda_device, dtype=dtype)
    with pytest.raises(ValueError, match="do not split"):
        fa_ops.flash_attention(q, k, k)
    k = torch.zeros(1, 8, 2, 16, device=cuda_device, dtype=dtype)
    with pytest.raises(TypeError, match="q is"):
        fa_ops.flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2), k, k)
    big = torch.zeros(1, 8, 2, 264, device=cuda_device, dtype=dtype)
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
