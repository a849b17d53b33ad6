"""Tests of the port that need a CUDA card: the hand-written kernels
(fused_step, svrg_step, mix_prox, RMSNorm, flash attention) against their
plain versions on the card, their operand checks, the resident
logistic-regression path through fused_step (dense and banded gossip), its
CUDA graph replays against the eager executor, fused_step over the cells of
a sweep against single launches (bitwise) and batched sweeps against
sequential ones, the kernel bench, a served model through RMSNorm and
flash, the kernels' refusal of operands that require grad, the
decentralized LM trainer on the card (against the CPU, a bitwise resume,
and the consensus of its checkpoint served through the kernels), and the
network-event scenarios (fused_step over per-step degraded mixing matrices,
a degraded-schedule sweep through the kernel, stale sweeps' graphs against
eager), and the execution modes (device sampling against the CPU and the
eager executor, the scan path, device-sampled sweeps, ``train_sweep`` and
device-sampled training with a bitwise resume), the MoE models
(stablelm-12b and the llama4 configs' smoke variants through the kernels,
an MoE layer's routing against the CPU's, MoE training deterministic and
resumed bitwise), and the SSM models (xlstm-350m and jamba-1.5-large's
smoke variants through the kernels and against the CPU, their engines
against the host batcher, xlstm training deterministic and resumed
bitwise), and the encoder-decoder and image-prefix models (whisper-base
and llava-next-mistral-7b's smoke variants through the kernels against the
plain routes and the CPU, their engines against the host batcher, flash at
their prefill shapes), and runs across ranks sharing the card (a
node-sharded run and a sharded LM step; node axes over two mesh dims and
checkpoints of sharded runs; Mamba and mLSTM on each rank's channels).
They skip, with
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
from torch.utils import _pytree as pytree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import pt_common, pt_kernel_bench  # noqa: E402
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm, cuda_graphs, graphs, prox, runner
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


def _cells_case(cells, m, d, rule, seed, device, shared):
    rng = np.random.default_rng(seed)
    n = 4 if rule == "svrg" else 2
    streams = [torch.as_tensor(rng.normal(size=(cells, m, d)),
                               dtype=torch.float32, device=device)
               for _ in range(n)]
    ws = np.stack([graphs.b_connected_ring_schedule(m, 2, seed=seed + c)
                   .consensus_rounds(0, 3) for c in range(cells)])
    w = torch.as_tensor(ws[0] if shared else ws, dtype=torch.float32,
                        device=device)
    if shared:
        return w, streams, 0.05, 0.01
    alpha = torch.as_tensor(rng.uniform(0.01, 0.3, cells),
                            dtype=torch.float32, device=device)
    lam = torch.as_tensor(rng.uniform(1e-3, 0.1, cells),
                          dtype=torch.float32, device=device)
    return w, streams, alpha, lam


# the figures' widths (784, 1024, 30, 54) and the bench's, over grids of 1
# to 16 cells: one launch gives the bits of single-cell launches
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("cells,d", [(1, 30), (3, 54), (4, 784),
                                     (16, 1024), (3, 131072)])
@pytest.mark.parametrize("prox_kind", ref.FUSED_PROXES)
@pytest.mark.parametrize("rule", ref.FUSED_RULES)
def test_cells_kernel_is_bitwise_single_launches_on_card(
        cuda_device, rule, prox_kind, cells, d, shared):
    w, streams, alpha, lam = _cells_case(cells, 8, d, rule, cells * d,
                                         cuda_device, shared)
    before = ops.launches_cells
    got = ops.fused_step_cells_buf(w, streams, alpha, lam, rule=rule,
                                   prox_kind=prox_kind)
    assert ops.launches_cells == before + 1
    lam_host = lam if shared else lam.tolist()
    for c in range(cells):
        want = ops.fused_step_buf(
            w if shared else w[c], [s[c] for s in streams],
            alpha if shared else alpha[c],
            lam_host if shared else lam_host[c], rule=rule,
            prox_kind=prox_kind)
        assert torch.equal(got[c], want)
    plain = ref.fused_step_cells_math(w, streams, alpha, lam, rule=rule,
                                      prox_kind=prox_kind)
    torch.testing.assert_close(got, plain, rtol=CARD_RTOL, atol=CARD_ATOL)


def test_cells_kernel_rejects_what_it_does_not_take(cuda_device):
    before = ops.launches_cells
    w = torch.eye(4, device=cuda_device)
    streams = [torch.zeros(3, 4, 8, device=cuda_device)] * 2
    with pytest.raises(ValueError, match="1 or 3 values"):
        ops.fused_step_cells_buf(w, streams, torch.ones(2, device=cuda_device),
                                 0.01, rule="sgd")
    with pytest.raises(ValueError, match="mixing matrices"):
        ops.fused_step_cells_buf(torch.eye(4, device=cuda_device)[None]
                                 .expand(2, 4, 4).contiguous(), streams, 0.1,
                                 0.01, rule="sgd")
    with pytest.raises(ValueError, match=r"\(B, m, d\)"):
        ops.fused_step_cells_buf(w, [s[0] for s in streams], 0.1, 0.01,
                                 rule="sgd")
    with pytest.raises(TypeError, match="float32"):
        ops.fused_step_cells_buf(w, [s.double() for s in streams], 0.1, 0.01,
                                 rule="sgd")
    assert ops.launches_cells == before


def _sweep_builds(device):
    from repro_torch.core import sweep  # noqa: F401
    ds = synthetic.make_paper_dataset("mnist_like", scale=0.02)
    data = params_from_numpy(synthetic.partition_per_node(ds, 8), device)
    x0 = torch.zeros(8, ds.dim, device=device)
    hp = algorithm.DPSVRGHyperParams(alpha=0.2, beta=1.2, n0=4, num_outer=6)

    def dpsvrg(lam=0.01):
        p = algorithm.Problem(_loss, prox.l1(lam), x0, data)
        return algorithm.dpsvrg_algorithm(p, hp), p

    steps = sum(dpsvrg()[0].meta.outer_lengths)

    def dspg(lam=0.01):
        p = algorithm.Problem(_loss, prox.l1(lam), x0, data)
        return algorithm.dspg_algorithm(
            p, algorithm.DSPGHyperParams(alpha0=0.2), steps), p

    return (dpsvrg, 0), (dspg, 10)


def test_batched_sweep_on_card_matches_sequential(cuda_device):
    """A Fig. 4 grid (three lambdas) batched through the cell-batched kernel
    in CUDA graphs: one launch a step for all cells, the (1, 1) ledger, and
    the histories of the sequential resident runs and of the CPU."""
    from repro_torch.core import sweep
    grid = {"lam": [0.001, 0.01, 0.1]}
    sched = graphs.b_connected_ring_schedule(8, 1)
    spec = ExecSpec(resident=True, kernel="fused", gossip="dense")
    for (build, every), (cpu_build, _) in zip(_sweep_builds("cuda"),
                                               _sweep_builds("cpu")):
        before = ops.launches_cells
        batched = sweep.run_sweep(build, grid, sched, spec,
                                  record_every=every)
        launches = ops.launches_cells - before
        sequential = sweep.run_sweep(build, grid, sched, spec,
                                     record_every=every, batched=False)
        cpu = sweep.run_sweep(cpu_build, grid, sched,
                              spec.replace(device="cpu"), record_every=every)
        assert launches == int(batched.history.steps[-1, 0])
        assert (batched.extras["transfers_h2d"],
                batched.extras["transfers_d2h"]) == (1, 1)
        assert batched.extras["replays"] > 0
        for other in (sequential, cpu):
            np.testing.assert_array_equal(batched.history.epochs,
                                          other.history.epochs)
            np.testing.assert_allclose(batched.history.objective,
                                       other.history.objective,
                                       rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
            np.testing.assert_allclose(batched.history.consensus,
                                       other.history.consensus, rtol=1e-3,
                                       atol=HISTORY_ATOL)


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


@pytest.mark.parametrize("case", [(1 / 3, 1 / 3, 1 / 3, 0.01),
                                  (0.5, 0.25, 0.25, 0.3)])
@pytest.mark.parametrize("n,offset", [(7, 0), (1000, 1), (300_001, 0)])
def test_mix_prox_kernel_reads_device_weights(cuda_device, n, offset, case):
    """The weights and threshold read from device memory (one-element
    tensors, as a node-sharded step passes its staged coefficients): one
    launch, the plain version's bits, also with only some of them
    tensors."""
    qs, qu, qd = _flat(n, 3, n + 2, cuda_device, offset)
    want = ref.mix_prox_ref(qs, qu, qd, *case)
    dev = torch.tensor(case, dtype=torch.float32, device=cuda_device)
    for args in ([dev[0], dev[1], dev[2], dev[3]],
                 [dev[0], case[1], dev[2], case[3]]):
        before = ops.launches_mix_prox
        got = ops.mix_prox(qs, qu, qd, *args)
        assert ops.launches_mix_prox == before + 1
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="tensor weight"):
        ops.mix_prox(qs, qu, qd, dev[:2], *case[1:])


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
    # whisper-base's decoder self-attention (MHA, hd 64) at its longest
    # prompt, and llava-next-mistral-7b's (GQA 4x, hd 128) over the
    # 1152-token image prefix and 128 prompt tokens
    (1, 8, 8, 224, 224, 64, True, None, None),
    (1, 32, 8, 1280, 1280, 128, True, None, None),
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

def _norm_sites(cfg) -> int:
    """The RMSNorm launches of one forward: norm1 (and post_norm1) a
    layer, norm2 (and post_norm2) a layer with an FFN, the final norm."""
    if cfg.norm != "rmsnorm":
        return 0
    per = 2 if cfg.post_norm else 1
    return sum(per * (1 + (p.ffn != "none"))
               for p in transformer.layer_plan(cfg)) + 1


def _flash_layers(cfg) -> int:
    return sum(p.mixer == "attn" and p.attn.chunk is None
               for p in transformer.layer_plan(cfg))


def _as_accurate(got, want, want64, factor=2.0, atol=1e-5):
    """``got`` lies at most ``factor`` times as far from ``want64`` as
    ``want`` does, plus ``atol``."""
    w64 = want64.detach().cpu().double()
    ref_err = float((want.detach().cpu().double() - w64).abs().max())
    err = float((got.detach().cpu().double() - w64).abs().max())
    assert err <= factor * ref_err + atol, (err, ref_err)


def _xlstm_f64(cfg, params, toks, steps):
    """The port's xlstm prefill of ``toks`` and decode of ``steps`` in
    float64 on the CPU (``pt_common.float64_models``), the yardstick of its
    ill-conditioned float32 runs (tests/test_torch_ssm.py,
    tests/test_torch_ssm_models.py): the logits of each, stacked, and the
    last cache."""
    cfg64 = cfg.scaled(param_dtype="float64", logit_dtype="float64",
                       use_flash=False, use_fused_norm=False)
    p64 = pytree.tree_map(lambda t: t.detach().cpu().double(), params)
    with pt_common.float64_models():
        lg, cache = transformer.prefill(cfg64, p64, toks.cpu(), max_len=64)
        out = [lg]
        for cur in steps:
            lg, cache = transformer.decode_step(cfg64, p64, cache, cur.cpu())
            out.append(lg)
    return torch.stack(out), cache


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-9b",
                                  "minicpm-2b", "stablelm-12b",
                                  "llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b",
                                  "xlstm-350m", "jamba-1.5-large-398b"])
def test_model_kernel_routes_match_plain_routes_on_card(cuda_device, arch):
    """Smoke size (4 layers for the llama4 configs, so the fourth is
    global), a prompt longer than the window and the chunk of 16: every
    RMSNorm is one launch (stablelm's LayerNorm none; xlstm's blocks one
    each, having no FFN), every full or windowed prefill attention layer
    one flash launch (chunked layers take the plain path), and the logits
    match the plain routes; xlstm's, ill-conditioned, lie no farther from
    its float64 run than twice the plain route's."""
    cfg = configs.smoke_variant(configs.get_config(arch))
    if cfg.moe_period and cfg.mixer_pattern == ("attn",):
        cfg = cfg.scaled(num_layers=4)
    kcfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda_device)
    norms, flash = _norm_sites(cfg), _flash_layers(cfg)
    rn_ops.launches = fa_ops.launches = 0
    lk, ck = transformer.prefill(kcfg, params, toks, max_len=64)
    assert (fa_ops.launches, rn_ops.launches) == (flash, norms)
    lp, cp = transformer.prefill(cfg, params, toks, max_len=64)
    kernel, plain, steps = [lk], [lp], []
    cur = lp.argmax(-1).to(torch.int32)
    for _ in range(3):
        steps.append(cur)
        lk, ck = transformer.decode_step(kcfg, params, ck, cur)
        lp, cp = transformer.decode_step(cfg, params, cp, cur)
        kernel.append(lk)
        plain.append(lp)
        cur = lp.argmax(-1).to(torch.int32)
    assert fa_ops.launches == flash
    assert rn_ops.launches == 4 * norms
    if arch == "xlstm-350m":
        _as_accurate(torch.stack(kernel), torch.stack(plain),
                     _xlstm_f64(cfg, params, toks, steps)[0])
    else:
        torch.testing.assert_close(torch.stack(kernel), torch.stack(plain),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_ssm_smoke_variants_on_card_equal_the_cpu(cuda_device, arch):
    """The same parameters on the card and on the CPU: the prefill and
    decode logits and every decode state (jamba's KV and Mamba states,
    xlstm's mLSTM and sLSTM states) agree, at the logits' tolerance for
    jamba, and for xlstm no farther from its float64 run than twice the
    CPU's float32 run."""
    cfg = configs.smoke_variant(configs.get_config(arch))
    params = transformer.init_params(cfg, 0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    lc, cc = transformer.prefill(cfg, params, toks, max_len=64)
    lk, ck = transformer.prefill(cfg, card, toks.to(cuda_device), max_len=64)
    cpu_out, card_out, steps = [lc], [lk], []
    cur = lc.argmax(-1).to(torch.int32)
    for _ in range(3):
        steps.append(cur)
        lc, cc = transformer.decode_step(cfg, params, cc, cur)
        lk, ck = transformer.decode_step(cfg, card, ck, cur.to(cuda_device))
        cpu_out.append(lc)
        card_out.append(lk)
        cur = lc.argmax(-1).to(torch.int32)
    if arch == "xlstm-350m":
        want64, cache64 = _xlstm_f64(cfg, params, toks, steps)
        _as_accurate(torch.stack(card_out), torch.stack(cpu_out), want64)
        for a, b, c in zip(pytree.tree_leaves(ck), pytree.tree_leaves(cc),
                           pytree.tree_leaves(cache64)):
            _as_accurate(a, b, c)
    else:
        torch.testing.assert_close(torch.stack(card_out).cpu(),
                                   torch.stack(cpu_out), **LOGIT_TOL)
        for a, b in zip(pytree.tree_leaves(ck), pytree.tree_leaves(cc)):
            torch.testing.assert_close(a.cpu(), b, **LOGIT_TOL)
    for a, b in zip(pytree.tree_leaves(ck), pytree.tree_leaves(cc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_ssm_engine_on_card_matches_host_batcher(cuda_device, arch):
    """The kernel routes on: 8 requests of one budget fill and empty the 4
    slots together (jamba's MoE decode batch shares capacity), prompts of
    2 to 33 tokens."""
    cfg = configs.smoke_variant(configs.get_config(arch)).scaled(
        use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate((2, 12, 20, 33, 7, 18, 9, 30))]
    eng = ResidentEngine(cfg, params, max_slots=4, max_len=64, chunk=3)
    host = ContinuousBatcher(cfg, params, max_slots=4, max_len=64)
    for r in reqs:
        eng.submit(r)
        host.submit(r)
    eout, hout = eng.run_until_done(), host.run_until_done()
    for r in reqs:
        np.testing.assert_array_equal(eout[r.uid], hout[r.uid])


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_engine_on_card_matches_host_batcher(cuda_device, dtype):
    """scout's smoke variant at 4 layers through the kernels: 8 requests of
    one budget fill and empty the 4 slots together, so both paths decode the
    same rows, whose tokens share one capacity slot an expert."""
    cfg = configs.smoke_variant(configs.get_config(
        "llama4-scout-17b-a16e")).scaled(num_layers=4, param_dtype=dtype,
                                         use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=6)
            for i, n in enumerate((5, 12, 20, 33, 7, 18, 9, 30))]
    eng = ResidentEngine(cfg, params, max_slots=4, max_len=64, chunk=3)
    host = ContinuousBatcher(cfg, params, max_slots=4, max_len=64)
    for r in reqs:
        eng.submit(r)
        host.submit(r)
    eout, hout = eng.run_until_done(), host.run_until_done()
    for r in reqs:
        np.testing.assert_array_equal(eout[r.uid], hout[r.uid])


def _mm_inputs(cfg, batch, seed, device):
    """The config's stub input (``models.multimodal``) on ``device``."""
    from repro_torch.models import multimodal
    if cfg.frontend == "vision_stub":
        arr = multimodal.fake_image_patches(batch, cfg.d_model,
                                            cfg.image_tokens, seed=seed)
        return {"image_embeds": torch.as_tensor(arr, device=device)}
    arr = multimodal.fake_audio_frames(batch, cfg.d_model, cfg.encoder_seq,
                                       seed=seed)
    return {"audio_frames": torch.as_tensor(arr, device=device)}


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_multimodal_smoke_variants_on_card(cuda_device, arch):
    """The kernel routes on the card against the plain routes on the card
    and against the CPU, the same parameters and inputs: flash one launch a
    decoder layer a prefill (whisper's encoder and cross-attention take the
    plain path), RMSNorm every norm site of llava (whisper's LayerNorm
    none), logits and the cache's cross K/V within the logits'
    tolerance."""
    cfg = configs.smoke_variant(configs.get_config(arch))
    kcfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    card = pytree.tree_map(lambda t: t.to(cuda_device), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(0))
    kw_cpu = _mm_inputs(cfg, 2, 1, "cpu")
    kw = _mm_inputs(cfg, 2, 1, cuda_device)
    rn_ops.launches = fa_ops.launches = 0
    lk, ck = transformer.prefill(kcfg, card, toks.to(cuda_device),
                                 max_len=64, **kw)
    assert (fa_ops.launches, rn_ops.launches) == \
        (cfg.num_layers, _norm_sites(cfg))
    lp, cp = transformer.prefill(cfg, card, toks.to(cuda_device), max_len=64,
                                 **kw)
    lc, cc = transformer.prefill(cfg, params, toks, max_len=64, **kw_cpu)
    kernel, plain, cpu = [lk], [lp], [lc]
    cur = lc.argmax(-1).to(torch.int32)
    for _ in range(3):
        lk, ck = transformer.decode_step(kcfg, card, ck, cur.to(cuda_device))
        lp, cp = transformer.decode_step(cfg, card, cp, cur.to(cuda_device))
        lc, cc = transformer.decode_step(cfg, params, cc, cur)
        kernel.append(lk)
        plain.append(lp)
        cpu.append(lc)
        cur = lc.argmax(-1).to(torch.int32)
    assert fa_ops.launches == cfg.num_layers
    assert rn_ops.launches == 4 * _norm_sites(cfg)
    torch.testing.assert_close(torch.stack(kernel), torch.stack(plain),
                               **LOGIT_TOL)
    torch.testing.assert_close(torch.stack(kernel).cpu(), torch.stack(cpu),
                               **LOGIT_TOL)
    for a, b in zip(pytree.tree_leaves(ck), pytree.tree_leaves(cc)):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.cpu(), b, **LOGIT_TOL)
    full, _ = transformer.forward(kcfg, card, toks.to(cuda_device), **kw)
    assert tuple(full.shape) == (2, 24, cfg.vocab_size)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_multimodal_engine_on_card_matches_host_batcher(cuda_device, arch):
    """The kernel routes on: 6 requests, each with its own audio or image,
    through 2 slots; one upload an admission."""
    from repro_torch.models import multimodal
    cfg = configs.smoke_variant(configs.get_config(arch)).scaled(
        use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    rng = np.random.default_rng(0)
    reqs = []
    for i, n in enumerate((3, 12, 20, 7, 18, 9)):
        if cfg.frontend == "vision_stub":
            kw = {"image_embeds": multimodal.fake_image_patches(
                1, cfg.d_model, cfg.image_tokens, seed=i)[0]}
        else:
            kw = {"audio_frames": multimodal.fake_audio_frames(
                1, cfg.d_model, cfg.encoder_seq, seed=i)[0]}
        reqs.append(Request(uid=i, tokens=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32),
            max_new_tokens=int(rng.integers(2, 9)), **kw))
    eng = ResidentEngine(cfg, params, max_slots=2, max_len=64, chunk=4)
    host = ContinuousBatcher(cfg, params, max_slots=2, max_len=64)
    for r in reqs:
        eng.submit(r)
        host.submit(r)
    eout, hout = eng.run_until_done(), host.run_until_done()
    for r in reqs:
        np.testing.assert_array_equal(eout[r.uid], hout[r.uid])
    assert eng.transfers["h2d"] == len(reqs)


def test_moe_layer_on_card_routes_as_the_cpu(cuda_device):
    """One MoE layer (16 experts, top-1, shared expert; capacity drops
    tokens): expert indices, slots and keep mask exactly the CPU's, the
    output within 1e-4 of its largest magnitude."""
    from repro_torch.models import moe
    spec = moe.MoESpec(d_model=256, d_ff=512, num_experts=16,
                       capacity_factor=1.0, shared_expert=True)
    params = moe.init_moe(torch.Generator().manual_seed(0), spec)
    x = torch.randn(2, 96, 256, generator=torch.Generator().manual_seed(1))
    card = {k: v.to(cuda_device) for k, v in params.items()}
    y, aux = moe.moe_forward(card, spec, x.to(cuda_device))
    yc, auxc = moe.moe_forward(params, spec, x)
    got = moe.route(card, spec, x.reshape(-1, 256).to(cuda_device))
    want = moe.route(params, spec, x.reshape(-1, 256))
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g.cpu(), w)
    assert not bool(want[4].all())
    assert float((y.cpu() - yc).abs().max()) <= 1e-4 * float(yc.abs().max())
    torch.testing.assert_close(aux.cpu(), auxc, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the engine's decode chunk as one CUDA graph
# ---------------------------------------------------------------------------

def _eager_greedy(logits):
    """The greedy sampler under another name: an engine given it runs its
    chunks eagerly, with the greedy engine's tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _graph_case_requests(cfg, seed):
    """Ten requests of one budget for 4 slots, prompts of 2 to 33 tokens;
    whisper's each with its audio."""
    from repro_torch.models import multimodal
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate((2, 12, 20, 33, 7, 18, 9, 30, 5, 14)):
        kw = {}
        if cfg.encoder_layers > 0:
            kw = {"audio_frames": multimodal.fake_audio_frames(
                1, cfg.d_model, cfg.encoder_seq, seed=i)[0]}
        reqs.append(Request(uid=i, tokens=rng.integers(
            0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=7,
            **kw))
    return reqs


def _served(cfg, params, reqs, **kw):
    """(engine, outputs, the kernels' launches while it served)."""
    from repro_torch import kernels
    eng = ResidentEngine(cfg, params, max_slots=4, max_len=64, chunk=3, **kw)
    before = kernels.launch_counts()
    for r in reqs:
        eng.submit(r)
    out = eng.run_until_done()
    torch.cuda.synchronize()
    return eng, out, [a - b for a, b in zip(kernels.launch_counts(), before)]


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "llama4-scout-17b-a16e",
                                  "xlstm-350m", "jamba-1.5-large-398b",
                                  "whisper-base"])
def test_graphed_engine_on_card_equals_eager_and_host_batcher(cuda_device,
                                                              arch):
    """The kernel routes on, ten requests through 4 slots, an EOS that
    retires slots mid-chunk where no MoE couples the rows (scout's and
    jamba's decode rows share capacity, so they run eight requests of one
    budget without EOS): the graphed engine gives the eager engine's and the host
    batcher's tokens, captures once and replays every chunk, and counts
    the eager engine's kernel launches; the eager engine records no
    capture."""
    cfg = configs.smoke_variant(configs.get_config(arch)).scaled(
        use_flash=True, use_fused_norm=True)
    if arch == "llama4-scout-17b-a16e":
        cfg = cfg.scaled(num_layers=4)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    reqs = _graph_case_requests(cfg, 0)
    eos = None
    if cfg.moe_experts:
        # two waves that fill and empty the slots together: every path
        # decodes the same rows
        reqs = reqs[:8]
    else:
        _, probe, _ = _served(cfg, params, reqs, sampler=_eager_greedy)
        eos = int(probe[0][3])
    eager, eout, elaunch = _served(cfg, params, reqs, eos_id=eos,
                                   sampler=_eager_greedy)
    graphed, gout, glaunch = _served(cfg, params, reqs, eos_id=eos)
    host = ContinuousBatcher(cfg, params, max_slots=4, max_len=64,
                             eos_id=eos)
    for r in reqs:
        host.submit(r)
    hout = host.run_until_done()
    for r in reqs:
        np.testing.assert_array_equal(gout[r.uid], eout[r.uid])
        np.testing.assert_array_equal(gout[r.uid], hout[r.uid])
    if eos is not None:
        assert any(len(o) < 7 for o in gout.values())
    assert eager.graphs == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert graphed.graphs["captures"] == 1
    assert graphed.graphs["replays"] == graphed.transfers["chunks"] > 1
    assert graphed.graphs["capture_s"] > 0
    assert graphed.transfers == eager.transfers
    assert glaunch == elaunch and sum(glaunch) > 0


def test_engine_whose_decode_step_cannot_be_captured_runs_eagerly(
        cuda_device, monkeypatch):
    """A decode step that syncs the host: its capture raises, the engine
    falls back to eager chunks with the greedy engine's tokens, and its
    counter shows no capture; random draws on the card work after it (a
    failed capture leaves torch's generators in capture mode unless they
    are released)."""
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b")).scaled(
        use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 1, device=cuda_device)
    reqs = _graph_case_requests(cfg, 1)
    _, want, _ = _served(cfg, params, reqs)
    step = transformer.decode_step

    def syncing(cfg, params, cache, token):
        int(token.sum())                         # a host sync
        return step(cfg, params, cache, token)

    monkeypatch.setattr(transformer, "decode_step", syncing)
    with pytest.warns(UserWarning, match="runs eagerly"):
        eng, got, _ = _served(cfg, params, reqs)
    for r in reqs:
        np.testing.assert_array_equal(got[r.uid], want[r.uid])
    assert eng.graphs == {"captures": 0, "replays": 0, "capture_s": 0.0}
    assert eng.transfers["chunks"] > 1
    assert bool(torch.isfinite(torch.randn(8, device=cuda_device)).all())


def test_a_failed_capture_leaves_the_generators_in_capture_mode(cuda_device):
    """What ``cuda_graphs._release_generators`` works around: where a host
    sync invalidates a capture, ``capture_end`` raises before torch takes
    its CUDA generators out of capture mode, and every later random draw on
    the card raises; the release makes draws work again.  This test fails
    once torch releases them itself, and the release can then go."""
    x = torch.ones(4, device=cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                float(x.sum())                   # a host sync
            finally:
                graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    try:
        with pytest.raises(RuntimeError, match="outside graph capture"):
            torch.randn(8, device=cuda_device)
    finally:
        cuda_graphs._release_generators()
    assert bool(torch.isfinite(torch.randn(8, device=cuda_device)).all())


# ---------------------------------------------------------------------------
# the kernels refuse autograd; the decentralized LM trainer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["x", "weight"])
def test_rmsnorm_kernel_refuses_operands_that_require_grad(cuda_device,
                                                            which):
    """The kernel has no backward: an output it wrote would carry no
    gradient, so the wrapper raises rather than return one."""
    x = torch.randn(4, 64, device=cuda_device)
    w = torch.zeros(64, device=cuda_device)
    (x if which == "x" else w).requires_grad_(True)
    before = rn_ops.launches
    with pytest.raises(RuntimeError, match="no backward"):
        rn_ops.rmsnorm(x, w)
    assert rn_ops.launches == before
    with torch.no_grad():                       # inference still launches
        out = rn_ops.rmsnorm(x, w)
    assert rn_ops.launches == before + 1
    torch.testing.assert_close(out, rn_ref.rmsnorm_ref(x.detach(),
                                                       w.detach()),
                               **RMS_TOL[torch.float32])


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_kernel_refuses_operands_that_require_grad(cuda_device, which):
    ops_in = {n: torch.randn(1, 16, 4 if n == "q" else 2, 32,
                             device=cuda_device) for n in "qkv"}
    ops_in[which].requires_grad_(True)
    before = fa_ops.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(ops_in["q"], ops_in["k"], ops_in["v"])
    assert fa_ops.launches == before
    with torch.no_grad():
        fa_ops.flash_attention(ops_in["q"], ops_in["k"], ops_in["v"])
    assert fa_ops.launches == before + 1


def _train_case(device, resident, ckpt_dir=None, resume=False, steps=12,
                arch="h2o-danube-1.8b", layers=2):
    """The smoke variant of ``arch`` (the danube's by default) trained on
    ``device`` from parameters drawn on the CPU (a generator on the card
    draws other values), so that runs on the card and on the CPU start
    from the same point."""
    from repro_torch.data.loader import LMLoader
    from repro_torch.train import steps as train_steps, trainer
    cfg = configs.smoke_variant(configs.get_config(arch)).scaled(
        num_layers=layers)
    toks = synthetic.make_token_stream(50_000, cfg.vocab_size, seed=0)
    ld = LMLoader(toks.tokens, num_nodes=4, per_node_batch=2, seq_len=32,
                  seed=1)
    tc = trainer.TrainerConfig(num_steps=steps, snapshot_every=5,
                               log_every=3, alpha=0.05, seed=0,
                               ckpt_dir=ckpt_dir,
                               ckpt_every=6 if ckpt_dir else 0)
    init = transformer.init_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_steps.transformer, "init_params",
                   lambda cfg_, seed, device: pytree.tree_map(
                       lambda t: t.to(device), init(cfg_, seed, "cpu")))
        return trainer.train_loop(
            cfg, prox.l1(1e-6),
            graphs.b_connected_ring_schedule(4, b=2, seed=0), ld, tc,
            exec=ExecSpec(resident=resident, device=device), resume=resume)


def test_trainer_on_card_matches_cpu_and_resumes_bitwise(cuda_device,
                                                         tmp_path):
    """The smoke danube trained on the card: host and resident paths agree
    with the CPU's run to float32 tolerance (the card's products sum in
    other orders), and a resume from the step-6 checkpoint is bitwise the
    uninterrupted run on the card."""
    import shutil
    from repro_torch import checkpoint
    cpu = _train_case("cpu", False)
    host = _train_case(cuda_device, False)
    full = _train_case(cuda_device, True, ckpt_dir=str(tmp_path / "full"))
    for got in (host, full):
        assert got["step"] == cpu["step"]
        np.testing.assert_allclose(got["loss"], cpu["loss"], rtol=1e-4,
                                   atol=1e-5)
    assert full["transfers"] == {"h2d": 1, "d2h": len(full["step"]) + 2}
    crash = str(tmp_path / "crash")
    shutil.copytree(str(tmp_path / "full"), crash)
    shutil.rmtree(os.path.join(crash, "step_00000012"))
    res = _train_case(cuda_device, True, ckpt_dir=crash, resume=True)
    by_step = dict(zip(full["step"], full["loss"]))
    assert res["step"] == [6, 9, 11]
    assert [by_step[s] for s in res["step"]] == res["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(res["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]


def test_moe_trainer_on_card_is_deterministic_and_resumes_bitwise(
        cuda_device, tmp_path):
    """scout's smoke variant at 4 layers (the aux in the loss) trained on
    the card: a second run is bit for bit the first (the dispatch's
    scatter and the combine's backward are deterministic), a resume from
    the step-6 checkpoint bitwise the uninterrupted run, and the first
    records, before routing can part on a last-bit difference, within the
    CPU's tolerance."""
    import shutil
    from repro_torch import checkpoint
    kw = dict(arch="llama4-scout-17b-a16e", layers=4)
    full = _train_case(cuda_device, True, ckpt_dir=str(tmp_path / "full"),
                       **kw)
    twin = _train_case(cuda_device, True, **kw)
    assert twin["loss"] == full["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(twin["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]
    cpu = _train_case("cpu", True, steps=4, **kw)
    assert cpu["step"] == full["step"][:2] == [0, 3]
    np.testing.assert_allclose(full["loss"][:2], cpu["loss"], rtol=1e-4,
                               atol=1e-5)
    crash = str(tmp_path / "crash")
    shutil.copytree(str(tmp_path / "full"), crash)
    shutil.rmtree(os.path.join(crash, "step_00000012"))
    res = _train_case(cuda_device, True, ckpt_dir=crash, resume=True, **kw)
    by_step = dict(zip(full["step"], full["loss"]))
    assert [by_step[s] for s in res["step"]] == res["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(res["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]


def test_xlstm_trainer_on_card_is_deterministic_and_resumes_bitwise(
        cuda_device, tmp_path):
    """xlstm's smoke variant at 4 layers (two mLSTM and two sLSTM blocks,
    their time loops under the node vmap) trained on the card: a second
    run is bit for bit the first, a resume from the step-6 checkpoint
    bitwise the uninterrupted run, and the first record within the CPU's
    tolerance (the runs are chaotic past it: tests/test_torch_train.py)."""
    import shutil
    from repro_torch import checkpoint
    kw = dict(arch="xlstm-350m", layers=4)
    full = _train_case(cuda_device, True, ckpt_dir=str(tmp_path / "full"),
                       **kw)
    twin = _train_case(cuda_device, True, **kw)
    assert twin["loss"] == full["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(twin["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]
    cpu = _train_case("cpu", True, steps=1, **kw)
    assert cpu["step"] == full["step"][:1] == [0]
    np.testing.assert_allclose(full["loss"][:1], cpu["loss"], rtol=1e-4,
                               atol=1e-5)
    crash = str(tmp_path / "crash")
    shutil.copytree(str(tmp_path / "full"), crash)
    shutil.rmtree(os.path.join(crash, "step_00000012"))
    res = _train_case(cuda_device, True, ckpt_dir=crash, resume=True, **kw)
    by_step = dict(zip(full["step"], full["loss"]))
    assert [by_step[s] for s in res["step"]] == res["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(res["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]


def test_consensus_of_a_card_run_serves_through_the_kernels(cuda_device,
                                                             tmp_path):
    from repro_torch.serve import consensus
    d = str(tmp_path / "ckpt")
    _train_case(cuda_device, True, ckpt_dir=d, steps=6)
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b"))
    params, info = consensus.consensus_params(d, cfg.scaled(
        use_flash=True, use_fused_norm=True), device=cuda_device)
    assert info.step == 6 and info.num_nodes == 4
    assert params["embed"].device.type == "cuda"
    kcfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    toks = torch.randint(0, cfg.vocab_size, (1, 40), device=cuda_device)
    rn_ops.launches = fa_ops.launches = 0
    lk, _ = transformer.prefill(kcfg, params, toks, max_len=64)
    assert (fa_ops.launches, rn_ops.launches) == (
        cfg.num_layers, 2 * cfg.num_layers + 1)
    lp, _ = transformer.prefill(cfg, params, toks, max_len=64)
    torch.testing.assert_close(lk, lp, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# network-event scenarios: per-step degraded mixing matrices, stale sweeps
# ---------------------------------------------------------------------------

def _degraded_ws(cells: int, m: int, steps: int, device) -> list:
    """Each step's (cells, m, m) stack of realized degraded matrices: link
    failures and node churn over a b=1 ring, one scenario seed a cell."""
    from repro_torch import scenarios
    base = graphs.b_connected_ring_schedule(m, 1)
    scheds = [scenarios.wrap_schedule(
        base, [scenarios.LinkFailures(0.3), scenarios.NodeChurn(0.3,
                                                                dwell=2)],
        seed=c) for c in range(cells)]
    return [torch.as_tensor(np.stack([s.matrix(t) for s in scheds]),
                            dtype=torch.float32, device=device)
            for t in range(steps)]


@pytest.mark.parametrize("d", [30, 1024])
@pytest.mark.parametrize("rule", ref.FUSED_RULES)
def test_cells_kernel_takes_per_step_degraded_mixing_matrices(cuda_device,
                                                              rule, d):
    """Per-step, per-cell doubly stochastic W with dropped links and
    isolated nodes (rows e_i): the cell-batched launch against its plain
    version and bitwise against single launches, at every step."""
    cells, m = 8, 8
    rng = np.random.default_rng(d)
    n_streams = 4 if rule == "svrg" else 2
    isolated = 0
    for w in _degraded_ws(cells, m, 12, cuda_device):
        streams = [torch.as_tensor(rng.normal(size=(cells, m, d)),
                                   dtype=torch.float32, device=cuda_device)
                   for _ in range(n_streams)]
        got = ops.fused_step_cells_buf(w, streams, 0.05, 0.01, rule=rule,
                                       prox_kind="l1")
        plain = ref.fused_step_cells_math(w, streams, 0.05, 0.01, rule=rule,
                                          prox_kind="l1")
        torch.testing.assert_close(got, plain, rtol=CARD_RTOL,
                                   atol=CARD_ATOL)
        for c in range(cells):
            assert torch.equal(got[c], ops.fused_step_buf(
                w[c], [s[c] for s in streams], 0.05, 0.01, rule=rule,
                prox_kind="l1"))
        for c, i in torch.nonzero(torch.diagonal(w, dim1=1, dim2=2) == 1.0
                                  ).tolist():
            # an isolated node mixes with itself only
            alone = ref.fused_step_cells_math(
                torch.eye(m, device=cuda_device), [s[c:c + 1]
                                                   for s in streams],
                0.05, 0.01, rule=rule, prox_kind="l1")[0, i]
            torch.testing.assert_close(got[c, i], alone, rtol=CARD_RTOL,
                                       atol=CARD_ATOL)
            isolated += 1
    assert isolated > 0


def _scenario_sweep(device, models, name, kernel):
    from repro_torch import scenarios
    from repro_torch.core import sweep
    ds = synthetic.make_paper_dataset("adult_like", scale=0.05)
    data = params_from_numpy(synthetic.partition_per_node(ds, 8), device)
    problem = algorithm.Problem(_loss, prox.l1(0.01),
                                torch.zeros(8, ds.dim, device=device), data)
    base = graphs.b_connected_ring_schedule(8, 1)
    scheds, backend = [], None
    for seed in (0, 1, 2):
        sched, backend = scenarios.apply(base, models, seed=seed)
        scheds.append(sched)

    def build():
        if name == "gt_svrg":
            return algorithm.gt_svrg_algorithm(problem, 0.1, 4, 10), problem
        return algorithm.loopless_dpsvrg_algorithm(
            problem, 0.2, 40, snapshot_prob=0.1), problem

    before = ops.launches_cells
    res = sweep.run_sweep(build, {"schedule": scheds, "seed": [0, 1]},
                          ExecSpec(resident=True, kernel=kernel,
                                   gossip=backend, device=device),
                          record_every=10)
    return res, ops.launches_cells - before


def _scenario_sweeps_agree(want, got) -> None:
    for field in ("steps", "epochs", "comm_rounds"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field))
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  want.extras["wire_bytes"])
    np.testing.assert_allclose(got.history.objective, want.history.objective,
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


def test_degraded_schedule_sweep_launches_fused_step_once_a_step(
        cuda_device):
    """Link failures and churn leave the wire stateless: a batched sweep
    over three degraded schedules launches the cell-batched fused_step once
    a step for all cells, and its histories are the plain step's and the
    CPU's."""
    from repro_torch import scenarios
    models = [scenarios.LinkFailures(0.3), scenarios.NodeChurn(0.2, dwell=5)]
    fused, launches = _scenario_sweep("cuda", models, "loopless", "fused")
    plain, plain_launches = _scenario_sweep("cuda", models, "loopless",
                                            "plain")
    cpu, _ = _scenario_sweep("cpu", models, "loopless", "fused")
    assert launches == int(fused.history.steps[-1, 0]) and \
        plain_launches == 0
    assert (fused.extras["transfers_h2d"],
            fused.extras["transfers_d2h"]) == (1, 1)
    for other in (plain, cpu):
        _scenario_sweeps_agree(other, fused)


@pytest.mark.parametrize("name", ["loopless_dpsvrg", "gt_svrg"])
def test_stale_sweep_graphs_match_eager_on_card(cuda_device, monkeypatch,
                                                name):
    """Stale gossip and stragglers (over link failures, so that every cell
    draws its own masks) thread a delay FIFO and the last sent iterate
    through every cell's state: the CUDA graphs' static state buffers take
    each step's shifted FIFO, so the graph replays equal the eager
    executor, and both equal the CPU."""
    from repro_torch import scenarios
    models = [scenarios.StaleGossip(3), scenarios.Stragglers(2.0),
              scenarios.LinkFailures(0.2)]
    graph, launches = _scenario_sweep("cuda", models, name, "fused")
    assert launches == 0                 # a threaded mix state: plain step
    assert graph.extras["replays"] > 0
    monkeypatch.setattr(runner, "CUDA_GRAPHS", False)
    eager, _ = _scenario_sweep("cuda", models, name, "fused")
    assert eager.extras["replays"] == 0
    cpu, _ = _scenario_sweep("cpu", models, name, "fused")
    for other in (eager, cpu):
        _scenario_sweeps_agree(other, graph)


# ---------------------------------------------------------------------------
# the execution modes: device sampling, the scan path, train_sweep
# ---------------------------------------------------------------------------

def _mode_problem(device):
    ds = synthetic.make_paper_dataset("adult_like", scale=0.05)
    data = params_from_numpy(synthetic.partition_per_node(ds, 8), device)
    return algorithm.Problem(_loss, prox.l1(0.01),
                             torch.zeros(8, ds.dim, device=device), data)


def _mode_run(name, device, **spec):
    problem = _mode_problem(device)
    before = ops.launches
    res = runner.run(_algo(name, problem), problem,
                     graphs.b_connected_ring_schedule(8, 1),
                     ExecSpec(gossip="dense", device=device, **spec),
                     record_every=0 if name == "dpsvrg" else 10)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return res, ops.launches - before


@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg", "dvr",
                                  "gt_svrg"])
def test_device_sampled_runs_on_card_match_cpu_and_eager(cuda_device,
                                                         monkeypatch, name):
    """sampling="device" on the card: the indices drawn in the graphs, one
    fused_step a step where the method has a fused twin, the graphs bit
    for bit the eager executor's, the card within float32 tolerance of the
    CPU (the stream is the same there), the ledger (1, 1)."""
    spec = dict(resident=True, sampling="device", kernel="fused")
    graph, launches = _mode_run(name, "cuda", **spec)
    monkeypatch.setattr(runner, "CUDA_GRAPHS", False)
    eager, eager_launches = _mode_run(name, "cuda", **spec)
    cpu, _ = _mode_run(name, "cpu", **spec)
    steps = int(graph.history.steps[-1])
    assert launches == eager_launches == (0 if name == "gt_svrg" else steps)
    assert graph.extras["graphs_built"] >= 1
    assert (graph.extras["transfers_h2d"],
            graph.extras["transfers_d2h"]) == (1, 1)
    np.testing.assert_array_equal(graph.history.objective,
                                  eager.history.objective)
    assert torch.equal(graph.params, eager.params)
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(graph.history, col),
                                   getattr(cpu.history, col),
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)


@pytest.mark.parametrize("key", [0, 1, 12345, 2**31 - 2])
def test_device_index_stream_on_card_equals_the_cpu_s(cuda_device, key):
    from repro_torch.core import device_sampling
    steps = torch.arange(1, 5000, dtype=torch.int64)
    kw = dict(m=8, bsz=3, n=50_000)
    want = device_sampling.IndexStream(key, device="cpu", **kw)(steps)
    got = device_sampling.IndexStream(key, device=cuda_device,
                                      **kw)(steps.to(cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg"])
def test_scan_path_on_card_matches_host_loop(cuda_device, name):
    """scan=True on the card: its record windows replay CUDA graphs of the
    pieces, and its histories are the host loop's to float tolerance."""
    scan, _ = _mode_run(name, "cuda", scan=True)
    host, _ = _mode_run(name, "cuda")
    assert 1 <= scan.extras["graphs_built"] <= \
        math.log2(runner.MAX_PIECE) + 1
    assert scan.extras["replays"] >= scan.extras["graphs_built"]
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(scan.history, col),
                                   getattr(host.history, col),
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
    np.testing.assert_array_equal(scan.history.epochs, host.history.epochs)


@pytest.mark.parametrize("name", ["dpsvrg", "loopless_dpsvrg"])
def test_device_sampled_sweep_on_card_launches_once_a_step(cuda_device,
                                                           name):
    """A device-sampled batched sweep: one cell-batched fused_step launch
    a step for all cells, each cell its sequential device-sampled run."""
    from repro_torch.core import sweep
    problem = _mode_problem("cuda")

    def build(lam=0.01):
        p = problem._replace(prox=prox.l1(lam))
        return _algo(name, p), p

    spec = ExecSpec(resident=True, sampling="device", kernel="fused",
                    gossip="dense")
    grid = {"lam": [0.001, 0.01, 0.1]}
    every = 0 if name == "dpsvrg" else 10
    sched = graphs.b_connected_ring_schedule(8, 1)
    before = ops.launches_cells
    bat = sweep.run_sweep(build, grid, sched, spec, record_every=every)
    torch.cuda.synchronize()
    assert ops.launches_cells - before == int(bat.history.steps[-1, 0])
    seq = sweep.run_sweep(build, grid, sched, spec, record_every=every,
                          batched=False)
    np.testing.assert_array_equal(bat.history.epochs, seq.history.epochs)
    np.testing.assert_allclose(bat.history.objective, seq.history.objective,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bat.history.consensus, seq.history.consensus,
                               rtol=1e-3, atol=1e-6)


def _smoke_lm(monkeypatch, algorithm_name="dpsvrg"):
    """(cfg, loader factory, TrainerConfig factory, trainer) of the smoke
    danube, its parameters drawn on the CPU so that card and CPU runs start
    alike."""
    from repro_torch.data.loader import LMLoader
    from repro_torch.train import steps as train_steps, trainer
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b"))
    toks = synthetic.make_token_stream(50_000, cfg.vocab_size, seed=0)
    init = transformer.init_params

    def loader():
        return LMLoader(toks.tokens, num_nodes=4, per_node_batch=2,
                        seq_len=32, seed=1)

    def tc(**kw):
        return trainer.TrainerConfig(**dict(dict(
            num_steps=12, snapshot_every=5, log_every=3, alpha=0.05,
            seed=0, algorithm=algorithm_name), **kw))

    monkeypatch.setattr(train_steps.transformer, "init_params",
                        lambda cfg_, seed, device: pytree.tree_map(
                            lambda t: t.to(device),
                            init(cfg_, seed, "cpu")))
    return cfg, loader, tc, trainer


@pytest.mark.parametrize("algorithm_name", ["dpsvrg", "dspg"])
def test_train_sweep_on_card_matches_train_loop_and_cpu(cuda_device,
                                                        monkeypatch,
                                                        algorithm_name):
    """train_sweep on the card: the cells equal the same sweep on the CPU
    and each its sequential resident train_loop on the card."""
    cfg, loader, tc, trainer = _smoke_lm(monkeypatch, algorithm_name)
    sched = graphs.b_connected_ring_schedule(4, b=2, seed=0)
    grid = {"lam": [1e-6, 1e-4], "alpha": [0.05, 0.02]}
    res = trainer.train_sweep(cfg, prox.l1, sched, loader(), tc(), grid,
                              ExecSpec(resident=True), mode="zip")
    cpu = trainer.train_sweep(cfg, prox.l1, sched, loader(), tc(), grid,
                              ExecSpec(resident=True, device="cpu"),
                              mode="zip")
    assert res["transfers"] == {"h2d": 1, "d2h": 1}
    np.testing.assert_allclose(res["loss"], cpu["loss"], rtol=1e-4,
                               atol=1e-5)
    for i, cell in enumerate(res["grid"]):
        seq = trainer.train_loop(cfg, prox.l1(cell["lam"]), sched, loader(),
                                 tc(alpha=cell["alpha"]),
                                 exec=ExecSpec(resident=True))
        np.testing.assert_allclose(np.asarray(res["loss"])[:, i],
                                   seq["loss"], rtol=1e-4, atol=1e-5)


def test_device_sampled_training_on_card_matches_cpu_and_resumes(
        cuda_device, monkeypatch, tmp_path):
    """Device-sampled training on the card draws the CPU's windows (within
    float32 tolerance of the CPU's losses) and resumes bitwise."""
    import shutil
    from repro_torch import checkpoint
    cfg, loader, tc, trainer = _smoke_lm(monkeypatch)
    sched = graphs.b_connected_ring_schedule(4, b=2, seed=0)
    spec = ExecSpec(resident=True, sampling="device")
    cpu = trainer.train_loop(cfg, prox.l1(1e-6), sched, loader(), tc(),
                             exec=spec.replace(device="cpu"))
    d = str(tmp_path / "full")
    full = trainer.train_loop(cfg, prox.l1(1e-6), sched, loader(),
                              tc(ckpt_dir=d, ckpt_every=6), exec=spec)
    np.testing.assert_allclose(full["loss"], cpu["loss"], rtol=1e-4,
                               atol=1e-5)
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000012"))
    res = trainer.train_loop(cfg, prox.l1(1e-6), sched, loader(),
                             tc(ckpt_dir=crash, ckpt_every=6), exec=spec,
                             resume=True)
    by_step = dict(zip(full["step"], full["loss"]))
    assert res["step"] == [6, 9, 11]
    assert [by_step[s] for s in res["step"]] == res["loss"]
    for a, b in zip(checkpoint.flatten_with_paths(res["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"])):
        assert torch.equal(a[1], b[1]), a[0]


# ---------------------------------------------------------------------------
# the launch tools, the last two examples and the serving bench
# ---------------------------------------------------------------------------

def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_card_has_its_row_of_rates(cuda_device):
    from repro_torch.launch import roofline
    # the H100 SXM has its row; another card raises by its name
    name = torch.cuda.get_device_properties(cuda_device).name
    if name != "NVIDIA H100 80GB HBM3":
        with pytest.raises(ValueError, match=name):
            roofline.HW.from_device(cuda_device)
        return
    assert roofline.HW.from_device(cuda_device) == roofline.HW()


@pytest.mark.parametrize("b,single", [(1, False), (3, True)])
def test_logreg_example_setting_on_card_matches_cpu(cuda_device, b, single):
    ex = _load_example("torch_decentralized_logreg")
    ops.launches = 0
    card = ex.run_setting("mnist_like", 8, b, 0.01, 0.2, 9, 0.02,
                          single=single, device=cuda_device)
    launches = ops.launches
    cpu = ex.run_setting("mnist_like", 8, b, 0.01, 0.2, 9, 0.02,
                         single=single, device="cpu")
    steps = 0
    for got, want in zip(card, cpu):
        np.testing.assert_array_equal(got.comm_rounds, want.comm_rounds)
        np.testing.assert_allclose(got.objective, want.objective,
                                   rtol=HISTORY_RTOL, atol=HISTORY_ATOL)
        np.testing.assert_allclose(got.consensus, want.consensus, rtol=1e-3,
                                   atol=1e-6)
        steps += int(got.steps[-1])
    assert launches == steps          # kernel="auto": one fused step a step


def test_batching_example_on_card_equals_cpu(cuda_device):
    ex = _load_example("torch_continuous_batching")
    cfg = configs.smoke_variant(configs.get_config("gemma2-9b"))
    params = transformer.init_params(cfg, 0, "cpu")
    argv = ["--arch", "gemma2-9b", "--requests", "5"]
    fa_ops.launches = rn_ops.launches = 0
    card = ex.main(argv + ["--device", "cuda"], params=pytree.tree_map(
        lambda t: t.to(cuda_device), params))
    assert fa_ops.launches == 5 * cfg.num_layers and rn_ops.launches > 0
    cpu = ex.main(argv + ["--device", "cpu"], params=params)
    assert sorted(card) == sorted(cpu) == list(range(5))
    for uid in card:
        np.testing.assert_array_equal(card[uid], cpu[uid])


def test_serve_bench_on_card(cuda_device):
    from benchmarks import pt_serve_bench
    rn_ops.launches = fa_ops.launches = 0
    ss = pt_serve_bench.serve_stats(cuda_device, iters=1)
    assert ss["outputs_equal"] and ss["device"].startswith("cuda")
    assert ss["transfers"]["resident"][0] == 24
    assert rn_ops.launches > 0 and fa_ops.launches > 0


def test_inspect_trace_counts_the_card_kernels(cuda_device, tmp_path):
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from repro_torch.launch import inspect_trace
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b")).scaled(
        use_flash=True, use_fused_norm=True)
    params = transformer.init_params(cfg, 0, cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    logits, cache = transformer.prefill(cfg, params, toks, max_len=48)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    # a warm-up cycle first, as chip_smoke.py's phase 29 records: the
    # first kernels of a trace can be lost while the device tracing starts
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                 ) as prof:
        for _ in range(2):
            rn_ops.launches = fa_ops.launches = 0
            with record_function("card.prefill"):
                transformer.prefill(cfg, params, toks, max_len=48)
            with record_function("card.decode"):
                transformer.decode_step(cfg, params, cache, nxt)
            torch.cuda.synchronize()
            prof.step()
    res = inspect_trace.analyze(str(path), top=1000)
    assert res["source"] == "kernels"
    rows = res["all_kernels"]
    flash = [r for r in rows if "flash_fwd" in r["name"]]
    norm = [r for r in rows if "rmsnorm" in r["name"]]
    assert sum(r["count"] for r in flash) == fa_ops.launches == \
        cfg.num_layers
    assert sum(r["count"] for r in norm) == rn_ops.launches == \
        2 * (2 * cfg.num_layers + 1)
    assert {r["scope"] for r in flash} == {"card.prefill"}
    assert {r["scope"] for r in norm} == {"card.prefill", "card.decode"}


def test_centralized_prox_gd_replayed_equals_eager_on_card(cuda_device,
                                                           monkeypatch):
    # F(x*)'s loop replayed from a CUDA graph: the eager loop's iterate and
    # objectives bit for bit (the same kernels), and the CPU's within the
    # card-vs-CPU tolerance of whole runs
    from repro_torch.core import dpsvrg

    def run(device):
        _, flat, h, _, d = pt_common.setup_problem("mnist_like", 0.05,
                                                   device=device)
        x, hist = dpsvrg.centralized_prox_gd(
            pt_common.logreg_loss, h, torch.zeros(d, device=device), flat,
            0.4, 200)
        return x.cpu(), hist

    x, hist = run(cuda_device)
    monkeypatch.setattr(runner, "CUDA_GRAPHS", False)
    x_eager, hist_eager = run(cuda_device)
    x_cpu, hist_cpu = run("cpu")
    assert hist.shape == (200,) and np.all(np.isfinite(hist))
    assert torch.equal(x, x_eager)
    np.testing.assert_array_equal(hist, hist_eager)
    np.testing.assert_allclose(hist, hist_cpu, rtol=1e-4, atol=1e-6)


def test_mesh_paths_on_one_card_match_their_unsharded_twins(cuda_device):
    """Two ranks sharing the card over gloo, host-staged: the
    node-sharded logistic-regression run (``shard="nodes"``) and a sharded
    train step of the toy LM (each leaf split over a model dim of 2, the
    placed tensors' collectives host-staged) equal their unsharded twins
    on the card, as their CPU twins do (tests/test_torch_mesh.py,
    tests/test_torch_mesh_lm.py)."""
    import _torch_mesh_workers as w
    from repro_torch.core import spmd
    init = pytree.tree_map(lambda x: x.numpy(), transformer.init_params(
        w.lm_cfg("tiny"), 0, "cpu"))
    ranks = spmd.spawn(w.card_mesh_cases, 2, backend="gloo", device="cuda",
                       args=(init,), timeout=300.0)
    nodes = w.run_node_case("nodes_dense", False, "cuda")
    lm = w.lm_train_steps(w.lm_cfg("tiny"), init, 2, "dense", "cuda")
    for got in ranks:
        assert got["wire"] == "gloo-host-staged"
        assert got["nodes"]["extras"]["wire"] == "gloo-host-staged"
        for field, want in nodes.history._asdict().items():
            np.testing.assert_allclose(got["nodes"]["history"][field],
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-7)
        np.testing.assert_allclose(got["nodes"]["params"],
                                   nodes.params.cpu().numpy(), rtol=1e-5,
                                   atol=1e-7)
        for a, b in zip(pytree.tree_leaves(got["lm"]["params"]),
                        pytree.tree_leaves(lm["params"])):
            np.testing.assert_allclose(a, b.detach().cpu().numpy(), rtol=0,
                                       atol=5e-5)
        np.testing.assert_allclose(got["lm"]["metrics"][:, 0],
                                   lm["metrics"][:, 0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["lm"]["metrics"][:, 1],
                                   lm["metrics"][:, 1], rtol=1e-4)


def _card_ckpt_cases(init, root, unsharded_dir) -> dict:
    import _torch_mesh_workers as w
    return w.ckpt_cases(init, root, unsharded_dir, "cuda")


def test_two_dim_node_axes_and_sharded_checkpoints_on_one_card(cuda_device,
                                                              tmp_path):
    """Four ranks sharing the card over gloo, host-staged, run the cases of
    tests/test_torch_mesh_ckpt.py on CUDA tensors: the ("multi",
    "faithful") plan's nodes over (pod, data), a rank's node row-major over
    them, equal to the same nodes over one dim (train steps, dense, banded
    and ppermute, and ``train_loop``, wire bytes exact); checkpoints of a
    sharded ``train_loop`` written by rank 0 alone, resumed bit for bit on
    the same mesh (dense and compressed), on the two-dim node axis and from
    an unsharded run's checkpoint within 1e-6."""
    import _torch_mesh_workers as w
    from repro_torch.core import spmd
    init = pytree.tree_map(lambda x: x.numpy(), transformer.init_params(
        w.lm_cfg("tiny"), 0, "cpu"))
    unsharded = w.lm_train_loop(4, "cuda", ckpt_dir=str(tmp_path / "one"),
                                **w.CKPT_RUN)
    w.crash_copy(str(tmp_path / "one"), str(tmp_path / "one-crash"))
    ranks = spmd.spawn(_card_ckpt_cases, 4, backend="gloo", device="cuda",
                       args=(init, str(tmp_path / "ranks"),
                             str(tmp_path / "one-crash")), timeout=600.0)

    def diff(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(
            y.detach().cpu() if isinstance(y, torch.Tensor) else y)).max())
            for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b))
            if x is not None)

    for rank, got in enumerate(ranks):
        assert got["multi_axis"]["index"] == rank
        assert got["multi_axis"]["name"] == "pod_data"
        for kind in ("dense", "banded", "ppermute"):
            assert diff(got[f"steps/multi/{kind}"]["params"],
                        got[f"steps/data4/{kind}"]["params"]) < 1e-6
        for kind in ("dense", "ppermute"):
            a, b = got[f"loop/multi/{kind}"], got[f"loop/data4/{kind}"]
            assert a["wire"] == b["wire"] == "gloo-host-staged"
            np.testing.assert_array_equal(a["wire_bytes"], b["wire_bytes"])
            assert diff(a["params"], b["params"]) < 1e-6
        assert got["writes"] == ({"save": 18, "prune": 18} if rank == 0
                                 else {"save": 0, "prune": 0})
        for kind in ("dense", "compressed"):
            full, resumed = got[f"ckpt/{kind}"], got[f"resumed/{kind}"]
            assert list(resumed["step"]) == [3, 4]
            assert diff(resumed["state"], full["state"]) == 0.0
            np.testing.assert_array_equal(resumed["loss"], full["loss"][3:])
        assert diff(got["resumed/multi"]["state"],
                    got["ckpt/dense"]["state"]) < 1e-6
        assert diff(got["resumed/from-unsharded"]["params"],
                    unsharded["params"]) < 1e-6


def _card_mixer_cases(mixers) -> dict:
    import _torch_mesh_workers as w
    from repro_torch.launch import mesh as mesh_lib
    mesh, plan = w.zoo_mesh("cuda")
    wide = mesh_lib.make_mesh((1, 4), ("data", "model"), "cuda")
    return {f"{kind}/{name}": w.mixer_run(kind, inputs, "cuda", plan, m)
            for kind, inputs in mixers.items()
            for name, m in (("model2", mesh), ("model4", wide))}


def test_channel_regions_on_one_card(cuda_device):
    """Mamba and mLSTM on each rank's channels, four ranks sharing the card
    over gloo (model=2 and model=4), as in tests/test_torch_mesh_zoo.py:
    the up-projection's halves regrouped, the states and decode steps,
    and Mamba's output and gradients, each within 1e-5 of its largest
    entry from the mixer on one card; mLSTM's output at most twice as far
    from the port's float64 run on the card as the unsharded float32 run,
    plus 1e-5.  mLSTM's gradients, ill-conditioned at random init, are
    held to the reference in float64 on the CPU
    (tests/test_torch_mesh_zoo.py): on an NVIDIA H100 the sharded
    up-projection's gradient lay 2.3x as far from the float64 run as the
    unsharded float32 one (0.1-0.2% of its largest entry, both)."""
    import _torch_mesh_workers as w
    from repro_torch.core import spmd
    mixers = {kind: w.mixer_inputs(kind, w.lm_cfg(arch).d_model)
              for kind, (arch, _) in w.ZOO_MIXERS.items()}
    ranks = spmd.spawn(_card_mixer_cases, 4, backend="gloo", device="cuda",
                       args=(mixers,), timeout=600.0)

    def as_np(t):
        return t.detach().cpu().double().numpy() \
            if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)

    for kind, inputs in mixers.items():
        want = w.mixer_run(kind, inputs, "cuda")
        if kind == "mlstm":
            inputs64 = pytree.tree_map(
                lambda a: a.astype(np.float64) if a.dtype.kind == "f"
                else a, inputs)
            with pt_common.float64_models():
                want64 = w.mixer_run(kind, inputs64, "cuda")
        for name in ("model2", "model4"):
            got = ranks[0][f"{kind}/{name}"]
            # the rank's block of a product is a product of its own shape,
            # which cuBLAS may sum in another order than the whole one's:
            # the regrouping moves values exactly (the CPU test holds it
            # bit for bit), the values differ by rounding, as phase 31's
            # Mamba check holds them (within 1e-5 of each leaf's largest
            # entry)
            for key in ("halves", "state", "step", "new_state"):
                for g, h in zip(pytree.tree_leaves(got[key]),
                                pytree.tree_leaves(want[key])):
                    h = as_np(h)
                    assert float(np.abs(np.asarray(g, np.float64) - h).max()
                                 ) <= 1e-5 * float(np.abs(h).max()), key
            if kind == "mlstm":
                g, h = np.asarray(got["out"], np.float64), as_np(want["out"])
                h64 = as_np(want64["out"])
                assert float(np.abs(g - h64).max()) <= \
                    2.0 * float(np.abs(h - h64).max()) + 1e-5
                continue
            for label, g, h in [("out", got["out"], want["out"])] + [
                    (k, got["grads"][k], want["grads"][k])
                    for k in want["grads"]]:
                g, h = np.asarray(g, np.float64), as_np(h)
                assert float(np.abs(g - h).max()) <= \
                    1e-5 * float(np.abs(h).max()), label
