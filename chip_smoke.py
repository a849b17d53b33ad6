#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is caught:

1. the card (``nvidia-smi`` name and power limit) and the torch / CUDA
   versions;
2. builds the CUDA kernels of the port (four sources; flash attention is
   two kernels, float32 and bf16, behind one entry point, and fused_step
   one kernel for one run or the cells of a sweep)
   from this checkout (``nvcc``, sm_90a, one process each, all started
   together), prints the build time and each ptxas report.  The flash
   library, the longest build, goes on building while phases 3-8 (which
   launch none of its kernels) run; phase 9 waits for it, prints its
   report and a ``flash_sass`` line: the number of ``HGMMA`` (wgmma)
   instructions in the built flash library, from ``cuobjdump -sass``;
3. holds the fused resident-step kernel against its plain PyTorch version
   on the card for both rules x three proxes at four shapes, and times
   kernel, plain version, ``torch.matmul(W, q)`` (``library_ms``: no single
   PyTorch call computes the fused function; the matrix product is its
   largest part), the bound and the launch floor (``floor_ms``: an empty
   kernel of ``fused_step.cu``, timed the same way);
4. holds ``svrg_step`` and ``mix_prox`` against their plain versions on the
   card (lengths 1, 7, 1000, 8 x 1024 and 2048 x 1024, and views at an odd
   offset; alpha in {0, 0.05, 1} by value and from device memory; the
   reference's mix cases): max abs err 0.  Times kernel, eager call, plain
   version and bound at 2048 x 1024 and 16384 x 1024, with the unfused
   torch chain beside them (no one PyTorch call computes either function,
   so ``library_ms`` is null);
5. times the plain and the fused DPSVRG step, and the update alone, at d
   in {30, 1024, 8192, 131072} (the measurements behind ``kernel="auto"``);
6. drives the logistic-regression path at full width: DPSVRG then DSPG
   with the same step count on ``cifar10_like`` at scale 1.0 (n = 50,000,
   d = 1,024), m = 8, a b=1 ring, the paper's hyper-parameters, through
   ``ExecSpec(resident=True, kernel="fused", gossip="dense")``, which on
   the card replays CUDA graphs of the chunks' pieces.  The fused
   kernel's launch count is set to 0 before and read after: it must equal
   the inner steps run.  Each run must build at most ceil(log2(longest
   chunk)) + 1 graphs and report the transfer ledger (1, 1).  Histories
   must be finite, the objective must fall, and both runs must match the
   same runs of the port on the CPU and the same runs through the eager
   executor on the card (``max_abs_graph_vs_eager``);
7. traces a shorter logistic-regression run (DPSVRG, 10 outer rounds) with
   ``torch.profiler``: the card's busy time, idle share, kernels per step;
8. runs the kernel bench at full width (``benchmarks/pt_kernel_bench``):
   ``run(scale=1.0)`` with every launch count set to 0 before and read
   after (svrg_step and mix_prox must equal the calls the bench made; the
   banded d = 131,072 loopless DPSVRG fused run must launch fused_step
   once per inner step), its histories held to the same bench run on the
   CPU, the bench's moving-iterate twin of that row (l1 at 1e-4) among
   them; then a DVR fused run on the same banded stack (launches equal to
   steps), the same DVR at l1 1e-4, where the iterate moves (its nonzero
   count printed, held to its CPU run and to the plain step on the card),
   and DSPG on the paper's b=1 ring through ``gossip="auto"``, which must
   pick ``banded``, all held to their CPU runs.  Every resident run of
   phases 6-8 must replay CUDA graphs;
9. holds the RMSNorm and flash attention kernels against their plain
   versions on the card (RMSNorm: rows in {1, 3, 4, 8, 6144}, d in {1, 7,
   128, 2304, 2560, 3584, 5120} and the first width past the register
   tiles, and the SSM models' float32 block norms at (4, 1024), (512,
   1024), (4, 8192) and (2048, 8192), and llava's at (4, 4096) and (3200,
   4096); flash: causal, window, softcap, GQA,
   bidirectional and ragged shapes, head_dim in {32, 33, 80, 128, 160,
   256}, the 6144-token prefills of h2o-danube-1.8b, stablelm-12b and
   scout's global layer, jamba's (1, 64/8, 2048, 128) causal, whisper's
   (1, 8/8, 224, 64) and llava's (1, 32/8, 3200, 128);
   float32 within rtol 1e-5 / atol 2e-5, bf16 within the element-wise
   bound ``ref.bf16_bound``), and times kernel, eager call,
   plain version, ``F.rms_norm`` / ``F.scaled_dot_product_attention``
   (``library_ms``, timed only), a copy of RMSNorm's input (``copy_ms``,
   the memory rate's yardstick) and the bound, with ``share_of_bound``
   (bound / kernel time) on every row.  A kernel's time (``graph_ms``)
   is the median of 7 samples of a CUDA graph of 20 calls, or, where a
   call takes longer than 50 us, of as many calls as fill 1 ms of the
   card's time (flash's eager calls alike);
10. runs h2o-danube-1.8b at full width in bf16 (random weights from a
   seed, 3.5 GB) through a 2048-token and a 6144-token prefill on the
   kernel path (exactly 24 bf16 flash launches each; each prefill is timed
   after one untimed call at its length) and on the plain path, and holds both to the float32 kernel path on the same weights
   cast back to float32: the kernel path's max abs logit error must stay
   within 1.5x the plain path's;
11. serves h2o-danube-1.8b at full width (24 layers, d_model 2560, f32,
   random weights from a seed, flash and RMSNorm kernels on) through
   ``ResidentEngine(max_slots=4, max_len=6208, chunk=8)``: 8 requests with
   prompts of 512 to 6144 tokens, 32 new tokens each.  The kernels' launch
   counts are set to 0 before and read after and must be exact; tokens
   must equal the host ``ContinuousBatcher``'s; the transfer ledger must
   be 8 uploads and one pull per chunk; each prefill's last logits and the
   teacher-forced decode logits must agree with the plain path
   (``use_flash=False, use_fused_norm=False``).  Prints ms per prefill,
   per chunk and per decode step, tokens/s, peak memory and the card's
   idle share over one traced prefill and one chunk;
12. replays a seeded Poisson stream through the same model (TTFT / TPOT);
13. runs ``repro_torch.launch.serve --arch h2o-danube-1.8b --stream`` at the
    launcher's smoke size;
14. holds fused_step's cell-batched launch (one launch for the B cells of
    a sweep) bitwise to B single-cell launches (operands drawn on the
    card) at (B, 8, d), d in {30, 54,
    784, 1024, 131072}, B in {1, 3, 4, 16}, both rules, three proxes, W
    and alpha / lam shared and per cell, and times it in a CUDA graph at
    (3, 8, 784), (4, 8, 784) and (4, 8, 1024) beside its bound, the same
    cells as single launches, the plain version and ``torch.bmm(W, q)``;
15. holds F(x*)'s proximal gradient replayed from a CUDA graph bit for
    bit to its eager loop (100 steps on Fig. 5's data; ``f_star_replay``
    line), then runs the paper's figures at scale 1.0 (Table I sizes, m =
    8) as batched sweeps through the kernel (``core/sweep.py``, CUDA
    graphs):
    Fig. 4 (three lambdas), Fig. 5 (four connectivities, one schedule a
    cell) and Fig. 1 (four seeds on each of the four datasets), DPSVRG then
    DSPG.  Every launch count is set to 0 before and read after: the
    cell-batched kernel must launch once per inner step of each sweep.
    Each sweep is held to its sequential resident runs and to the batched
    plain step (counting columns exact, objective rtol 1e-4 / atol 1e-6,
    consensus rtol 1e-3), with the ledger (1, 1) and at most
    ceil(log2(longest chunk)) + 1 graphs; one Fig. 4 cell is held to the
    CPU's host loop.  Prints ms per cell-step batched and sequential, the
    figures' derived columns and whether the paper's orderings hold
    (recorded, not asserted);
16. trains h2o-danube-1.8b at full width cut to 1 layer (151 M
    parameters a node, float32, random weights from seed 0) on m = 4 nodes
    of the b=2 ring with the decentralized trainer (``train/trainer.py``):
    DPSVRG for 20 steps on the host loop, then on the resident path with
    checkpoints at steps 10 and 20 (losses agree, rtol 1e-4 / atol 1e-5;
    ledgers exact); a resume from the step-10 checkpoint, bitwise the
    uninterrupted run (records and every state leaf); DSPG for 20 steps,
    resident then on the host loop (the same checks).
    Prints ms a step, the step's TFLOP/s (6 x parameters x tokens a
    gradient evaluation), the snapshot refresh, checkpoint save and restore
    seconds, peak memory and the card's idle share over one traced step;
    losses must be finite.  Then serves the consensus of the final
    checkpoint (``serve/consensus.py``) through the RMSNorm and flash
    kernels: 4 prompts of 256-1024 tokens, 16 new tokens each, launch
    counts exact, tokens equal to the host batcher's, logits within 1e-3 of
    the plain path; and runs ``repro_torch.launch.train --steps 10
    --ckpt-dir`` and ``repro_torch.launch.serve --ckpt-dir`` on it as
    subprocesses (``train_consensus`` line);
17. runs the network-event scenarios (``repro_torch.scenarios``) through
    the batched sweeps.  ``scenario_kernel``: DPSVRG with the main path's
    hyper-parameters on ``cifar10_like`` at scale 1.0 over a (failure x
    seed) grid, {none, LinkFailures(0.3), NodeChurn(0.2, dwell=5), both}
    x {0, 1}, built with ``scenarios.apply``: every step of every cell
    has its own realized doubly stochastic W (an isolated node's row is
    e_i).  Every launch count is set to 0 before the fused sweep and read
    after: the cell-batched fused_step must launch once per step for all
    8 cells.  Held to the batched plain step, to sequential resident runs
    (counts set to 0 before and read after: one single launch a
    cell-step) and to the CPU (objective rtol 1e-4 / atol 1e-6, consensus
    rtol 1e-3; steps, gossip rounds and wire bytes exact), and a moving
    twin at l1 1e-4 (iterates and consensus batched against sequential and
    against the same sweep on the CPU, each failure cell's iterate more
    than that tolerance from its undegraded cell's); at
    most ceil(log2(longest chunk)) + 1 graphs, the ledger (1, 1), the
    zero-intensity cells bitwise an unwrapped batched sweep's, every
    cell's final iterate nonzero; fused_step over those cells is timed at
    (8, 8, 1024) with a new W stack each call (``scenario_kernel_case``).
    ``scenario_stale``: loopless DPSVRG and GT-SVRG under StaleGossip(3) +
    Stragglers(2.0) (l1 1e-4, where both iterates move), two seeds
    batched through the plain step with the delay FIFO in every cell's
    state: CUDA graphs against the eager executor against the CPU.
    ``beyond_noniid``: ``benchmarks/pt_beyond_noniid.py``'s matrix at
    scale 1.0 (adult_like, heterogeneity 0.7, 48 cells in 12 programs,
    int8 among them), batched rows against sequential ones (objective rtol
    1e-4, int8 rows 1e-3, a bound on drift that cannot tell int8 from f32;
    counts and wire bytes exact), each program's ledger (1, 1); the same
    matrix over its first 12 steps, before any int8 code flips, batched
    against sequential at rtol 1e-4 / atol 1e-6 in every objective and
    every iterate, each int8 program's iterates outside that tolerance of
    its f32 twin's; ms a cell-step batched and sequential and the
    frontier's first four entries (``scenarios`` line);
19. runs the execution modes (``exec_modes`` line).
    ``device_sampling``: phase 6's main path (DPSVRG then DSPG,
    ``kernel="fused"``, CUDA graphs) with ``sampling="device"``: the
    minibatch indices drawn on the card from the counter-based stream
    (``core/device_sampling.py``).  fused_step's count is set to 0 before
    and read after: one launch a step; at most ceil(log2(longest chunk)) +
    1 graphs, bit for bit the eager executor's; the card held to the CPU
    (rtol 1e-4 / atol 1e-6; the stream is the same there); the final
    objective within a third of the host-sampled run's descent of it; the
    ledger (1, 1); ms a step beside host sampling, timed in turns in this
    process, and both runs' traced idle shares.  ``scan_path``: DSPG, 600
    steps, a record every 50, through ``scan=True`` against the host loop
    on the card (rtol 1e-4 / atol 1e-6), its ledger (12 uploads, 26 pulls)
    and graphs.  ``sweep_device_sampling``: Fig. 4's lambda grid batched
    with device sampling through the cell-batched fused_step (one launch a
    step for all cells), each cell equal to its sequential device-sampled
    run at phase 15's tolerances.  ``train_sweep``: h2o-danube-1.8b at
    full width cut to 1 layer, m = 4 nodes of the b=2 ring, DPSVRG, a
    (lambda, alpha) grid of two cells for 10 steps (refreshes at steps 0
    and 5) through ``trainer.train_sweep``, each cell's losses held to a
    sequential resident train_loop of that cell (rtol 1e-4 / atol 1e-5),
    the ledger (1, 1), ms a cell-step batched and sequential, the peak
    memory, and one traced sweep and train_loop (busy time, top kernels).
    ``train_device_sampling``: the same size, one cell, with
    ``sampling="device"``, 10 steps, and a run stopped at step 5 with its
    checkpoint (under ``build/phase19``, removed after) resumed to step
    10 bitwise the uninterrupted run;
21. serves stablelm-12b at full width cut from 40 to 10 layers (float32
    weights from a seed; LayerNorm and qk-norm, flash at head_dim 160 on
    every layer) through phase 11's
    engine and requests (``stablelm_serve`` line): flash launches exactly
    10 a prefill and no RMSNorm launch, tokens equal to the host
    batcher's, each prefill's last logits and the teacher-forced decode
    logits within 1e-3 of the plain path, then a short Poisson stream
    (TTFT, TPOT); prints ms a prefill and a decode step and the peak;
22. the same for llama4-scout-17b-a16e at full width cut to 4 layers
    (9.84 B parameters, 39.4 GB; layers 0-2 chunked-local on the plain
    path, layer 3 global with NoPE through flash; a 16-expert top-1 MoE
    with a shared expert on every layer): RMSNorm exactly 9 launches a
    forward, flash 1 a prefill; the tokens capacity drops, by batch size;
    then layer 0's MoE at full width on a 512-token input held to the same
    layer on the CPU (routing exactly equal, the output within 1e-4 of its
    largest magnitude; the tokens dropped per expert) (``scout_serve``);
23. the same for llama4-maverick-400b-a17b at full width cut to 2 layers
    in bf16 (17.5 B parameters, 35.0 GB; layer 1 a 128-expert MoE, both
    layers chunked, so no flash launch): RMSNorm exactly 5 launches a
    forward, tokens equal to the host batcher's (capacity is 1 an expert
    at 4 slots: the decode drops are printed), every RMSNorm site of a
    prefill held to its plain version within the bf16 tolerance; the
    logits of the bf16 kernel and plain paths are printed, not held (a
    last-bit difference at a routing near-tie moves a token to another
    expert) (``maverick_serve``);
24. trains scout's smoke variant at 4 layers on the card with the aux in
    the loss (m = 4, resident): each step held to the CPU's step from the
    same state, two runs bit for bit equal, a resume from step 6 bitwise
    (``moe_train``); then the same for xlstm-350m's smoke variant at 2
    layers, an mLSTM and an sLSTM block (``xlstm_train``);
25. serves xlstm-350m at full width and depth (24 mLSTM / sLSTM blocks,
    391.7 M parameters, float32, from a seed) through phase 11's engine: 8
    requests of 32-128 tokens, 16 new each, 4 slots, chunk 8: RMSNorm
    exactly 25 launches a forward, no flash launch, tokens equal to the
    host batcher's; its float32 logits are mostly not determined to 1e-3
    at random init (the mLSTM normalizer has poles), so the kernel path's
    logits are held within 1e-3 of the plain path's and of the float64
    run's on each prompt's first 6 positions where float32 determines
    them (position 0 always), and the whole prompts' differences are
    printed; then a Poisson stream (TTFT, TPOT), the bound of a decode
    step (weights and states over the memory rate), one traced decode
    step, and one mLSTM and one sLSTM layer at full width on 128 tokens
    held to the CPU (within 1e-4 of the largest |y|; the mLSTM where
    float32 determines it) (``xlstm_serve``);
26. serves jamba-1.5-large at full width cut to 2 layers (11.38 B
    parameters, 45.5 GB float32): layer 0 attention through flash at
    (1, 64/8, S, 128) with a dense swiglu FFN, layer 1 Mamba with a
    16-expert top-2 MoE; 8 requests of 256-2048 tokens: flash exactly 1
    launch a prefill, RMSNorm 5 a forward, tokens equal to the host
    batcher's, logits within 1e-3 of the plain path, the capacity drops,
    the same timings, and the Mamba layer on 512 tokens held to the CPU
    (``jamba_serve``);
27. serves whisper-base at full size (6 encoder and 6 decoder layers, d
    512, 105 M parameters, float32, from a seed) through phase 11's
    engine: 8 requests, each with its own 1500 frames of stub audio
    (``models.multimodal.fake_audio_frames``, seed = uid), prompts of
    4-224 tokens, 32 new each, 4 slots, chunk 8: flash exactly 6 launches
    a prefill (the decoder's causal self-attention; the encoder and the
    cross-attention take the plain path), no RMSNorm launch (LayerNorm),
    tokens equal to the host batcher's, logits within 1e-3 of the plain
    path; a Poisson stream whose requests carry their audio; the encoder
    on 1500 frames held to the same weights on the CPU (within 1e-4 of
    its largest magnitude) and timed; two requests with the same tokens
    and other audio decode to other tokens; a decode step against its
    bound (``whisper_serve``);
28. the same for llava-next-mistral-7b at full width cut from 32 to 16
    layers (d 4096, 32 / 8 heads, 3.63 B parameters, 14.5 GB float32):
    8 requests, each with its own 1152-token stub image prefix, prompts
    of 64-2048 tokens, max_len 4096: flash exactly 16 launches a prefill
    over prefix and prompt, RMSNorm 33 a forward; then layer 0 at full
    width on the prefix and 128 tokens held to the CPU (``llava_serve``);
29. (run right after phase 12, on phase 11's weights, so that their 7 GB
    are not held through phases 13-28) the launch tools
    (``launch_tools`` line).  (a) h2o-danube-1.8b at full width (24
    layers, float32, the kernel path): a 6144-token prefill (batch 1) and
    a 4-slot decode step at context 6144, each timed on the host clock
    around ``synchronize()`` (median of 5 after a warm-up, launch counts
    exact), read against ``launch.analytic`` and ``launch.roofline`` at
    the card's rates (``HW.from_device``): one ``launch_roofline`` line
    each, with the analytic GFLOP and GB (``dtype_bytes=4``),
    ``t_compute``, ``t_memory``, the bottleneck (the prefill must be
    bound by operations, the decode by bytes), the measured ms and
    ``share = max(t_c, t_m) / measured``, which must not pass 1.05;
    (b) one prefill and one decode step traced with ``torch.profiler``,
    exported to ``build/phase29/danube_steps.json`` and read by
    ``launch.inspect_trace``: its top list must name the port's flash and
    RMSNorm kernels, and its counts equal the wrappers' (a decode step
    launches no flash kernel); (c) ``examples/torch_decentralized_logreg
    .py`` on the card against the same code on the CPU (every run's
    histories at the card-vs-CPU tolerances, one fused_step launch a
    step), ``examples/torch_continuous_batching.py`` (tokens equal to the
    CPU's on the same weights, flash and RMSNorm launched) and
    ``benchmarks/pt_serve_bench.py`` (host and engine tokens equal, the
    ledger O(1) a chunk);
30. prints the card, a ``{"kernels": [...]}`` line (all seven kernels,
    each with its ``share_of_bound``; RMSNorm and flash also with
    ``launches_consensus_serve``, phase 16's count,
    ``launches_{stablelm,scout,maverick,xlstm,jamba,whisper,llava}_serve``,
    phases 21-23's and 25-28's, and ``launches_launch_tools``, phase 29's
    timed danube steps; fused_step with ``launches_logreg_example``, phase
    29's;
    fused_step_cells with ``launches_scenarios``, phase 17's cell-batched
    count, and fused_step with the single launches of phase 17's
    sequential runs; fused_step and fused_step_cells with
    ``launches_exec_modes``, phase 19's counts),
    and last ``{"ok": true, "device": {...}}``.  (Until phase 21 came,
    these final lines were phase 20; until phase 25, phase 25; until
    phase 27, phase 27; until phase 29, phase 29.)

Needs one card; exits non-zero without one, and without the repository
around it.
"""

import atexit
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import checkpoint, configs, scenarios  # noqa: E402
from repro_torch.configs import paper_logreg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import (algorithm, device_sampling,  # noqa: E402
                              gossip, graphs, prox, runner, sweep,
                              transport)
from repro_torch.core.exec_spec import ExecSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.loader import LMLoader  # noqa: E402
from repro_torch.kernels import SOURCES, _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.fused_update import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402
from repro_torch.launch import analytic as launch_analytic  # noqa: E402
from repro_torch.launch import inspect_trace  # noqa: E402
from repro_torch.launch import roofline as launch_roofline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import moe, multimodal, transformer  # noqa: E402
from repro_torch.serve import consensus  # noqa: E402
from repro_torch.serve import metrics as serve_metrics  # noqa: E402
from repro_torch.serve import stream as serve_stream  # noqa: E402
from repro_torch.serve.engine import ResidentEngine  # noqa: E402
from repro_torch.serve.scheduler import (ContinuousBatcher,  # noqa: E402
                                         Request, modality_inputs)
from repro_torch.train import steps, trainer  # noqa: E402
from benchmarks import pt_common, pt_kernel_bench  # noqa: E402
from benchmarks import pt_serve_bench  # noqa: E402

# the card's rates from the package's one table (launch/roofline.py's HW,
# NVIDIA's H100 SXM data sheet, dense): device memory, and peak operation
# rates by operand type, float32 outside the tensor cores, bf16 on them.  A
# bf16 bound is taken at the tensor-core rate even for a kernel that does
# not use them, since the card could do the work at that rate.
H100 = launch_roofline.HW()
HBM_BYTES_PER_S = H100.hbm_bw
FLOPS_PER_S = {torch.float32: H100.peak_flops(torch.float32),
               torch.bfloat16: H100.peak_flops(torch.bfloat16)}
KERNEL_SHAPES = [(8, 1024), (8, 1000), (8, 131072), (32, 4096)]
AUTO_DIMS = [30, 1024, 8192, 131072]
# kernel vs plain version on the card: both float32, but the kernel sums
# the m mix terms with FMAs in k order and cuBLAS in its own order, so they
# differ by float32 rounding of O(1) terms, growing with m
KERNEL_RTOL = 1e-5
KERNEL_ATOL = 1e-5
# port on the card vs port on the CPU, whole runs: the same float32
# arithmetic summed in different orders (the kernel and cuBLAS vs ATen's CPU
# kernels), compounded over the run — the tolerance of the CPU parity tests
HISTORY_RTOL = 1e-4
HISTORY_ATOL = 1e-6


# builds running in the background, stopped when the script exits (a
# failed phase does not leave an nvcc behind)
_BACKGROUND: list = []
atexit.register(lambda: [job.kill() for job in _BACKGROUND])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def print_build(logs: dict, sources, t_build: float) -> None:
    """The compiler's report of each source built, and the time since the
    build started (``t_build``, a ``perf_counter`` reading)."""
    for source, log in logs.items():
        print(f"--- ptxas: {source.name} "
              f"({log.count('Compiling entry function')} kernels)",
              flush=True)
        print(log.strip(), flush=True)
    print(f"build: {', '.join(s.name for s in sources)} in "
          f"{time.perf_counter() - t_build:.1f} s", flush=True)


# a timed sample makes TIMED_CALLS calls, or fewer where a call is slow:
# as many as take SAMPLE_MS of the card's time, at least one (a sample of a
# millisecond or more is far above the events' resolution)
TIMED_CALLS = 20
SAMPLE_MS = 1.0


def _calls_for(fn) -> int:
    """The calls a sample of ``fn`` makes: TIMED_CALLS, or as many as fill
    SAMPLE_MS where one call takes longer than SAMPLE_MS / TIMED_CALLS.
    A call's time is the least of three single calls timed warm: one slow
    call (a lazy set-up on this stream) must not shrink the sample of a
    microsecond kernel to one call and its graph launch."""
    once = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        once.append(start.elapsed_time(stop))
    return max(1, min(TIMED_CALLS,
                      math.ceil(SAMPLE_MS / max(min(once), 1e-9))))


def time_ms(fn, iters: int | None = TIMED_CALLS, samples: int = 7) -> float:
    """Median per-call time in ms: CUDA events around ``iters`` calls
    (``None``: ``_calls_for``), over ``samples`` samples, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if iters is None:
        iters = _calls_for(fn)
    per_call = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters: int | None = None) -> float:
    """Median device time per call of ``fn``: ``iters`` calls (``None``:
    ``_calls_for``) captured in one CUDA graph, the graph's replays timed
    by ``time_ms``.  The host's Python and launch overhead is out of the
    graph, so this is the card's time for the work, gaps between the
    captured kernels included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    if iters is None:
        iters = _calls_for(fn)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, iters=5) / iters


def logreg_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))  # Eq. 26


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_case(m: int, d: int, rule: str, seed: int, device):
    rng = np.random.default_rng(seed)
    n_streams = 4 if rule == "svrg" else 2
    streams = [torch.as_tensor(rng.normal(size=(m, d)), dtype=torch.float32,
                               device=device) for _ in range(n_streams)]
    # a doubly-stochastic mixing matrix: 3 rounds of a random b=2 ring
    w = graphs.b_connected_ring_schedule(m, 2, seed=seed).consensus_rounds(
        0, 3)
    return torch.as_tensor(w, dtype=torch.float32, device=device), streams


def fused_bound(m: int, d: int, rule: str, prox_kind: str):
    """(bound ms, what bounds it): each input read once, the output written
    once; flops of the elementwise direction, the step, the mix and the
    prox."""
    n_streams = 4 if rule == "svrg" else 2
    nbytes = (n_streams + 1) * m * d * 4 + m * m * 4
    flops = m * d * ((2 if rule == "svrg" else 0) + 2) + 2 * m * m * d \
        + m * d * {"l1": 4, "sql2": 1, "none": 0}[prox_kind]
    return bound(nbytes, flops)


def noop_floor_ms() -> float:
    """The launch floor: an empty kernel of fused_step.cu (one block),
    timed as the kernel is (``graph_ms``)."""
    def noop():
        rc = kernel.noop_launch()
        if rc != 0:
            fail(f"the empty kernel did not launch (status {rc})")
    return graph_ms(noop)


def check_kernel(device) -> dict:
    alpha, lam = 0.05, 0.01
    rows = {}
    floor = noop_floor_ms()
    for m, d in KERNEL_SHAPES:
        for rule in ref.FUSED_RULES:
            for prox_kind in ref.FUSED_PROXES:
                w, streams = kernel_case(m, d, rule, seed=m * d, device=device)
                out = ops.fused_step_buf(w, streams, alpha, lam, rule=rule,
                                         prox_kind=prox_kind)
                plain = ref.fused_step_math(w, streams, alpha, lam, rule=rule,
                                            prox_kind=prox_kind)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, plain, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
                err = float((out - plain).abs().max())
                # the same alpha from device memory (the resident path's way)
                alpha_dev = torch.tensor([alpha], dtype=torch.float32,
                                         device=device)
                out_dev = ops.fused_step_buf(w, streams, alpha_dev[0], lam,
                                             rule=rule, prox_kind=prox_kind)
                if not torch.equal(out_dev, out):
                    fail(f"alpha from device memory differs: {rule} "
                         f"{prox_kind} {(m, d)}")
                q = streams[0] - alpha * streams[1]
                bound, bound_by = fused_bound(m, d, rule, prox_kind)
                # called as the resident path calls them: alpha on the card
                a = alpha_dev[0]

                def kern():
                    return ops.fused_step_buf(w, streams, a, lam, rule=rule,
                                              prox_kind=prox_kind)

                def plain_fn():
                    return ref.fused_step_math(w, streams, a, lam, rule=rule,
                                               prox_kind=prox_kind)

                # ms / plain_ms / library_ms: the card's time (CUDA graphs);
                # call_ms / plain_call_ms: eager calls, host overhead in
                row = {
                    "shape": [m, d], "rule": rule, "prox": prox_kind,
                    "max_abs_err": err,
                    "ms": graph_ms(kern), "plain_ms": graph_ms(plain_fn),
                    "library_ms": graph_ms(lambda: torch.matmul(w, q)),
                    "bound_ms": bound, "bound_by": bound_by,
                    "floor_ms": floor,
                    "call_ms": time_ms(kern), "plain_call_ms": time_ms(plain_fn),
                    "launches": ops.launches,
                }
                rows[(m, d, rule, prox_kind)] = row
                print("kernel_case " + json.dumps(row), flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: svrg_step and mix_prox against their plain versions
# ---------------------------------------------------------------------------

# lengths of the flat buffers: a single element, a ragged tail of 3 after a
# float4, a ragged tail after 250 float4s, one (8, 1024) TPU tile, and the
# kernel bench's 8 MiB per stream
SVRG_MIX_LENGTHS = [1, 7, 1000, 8 * 1024, 2048 * 1024]
# views one element into a buffer: not 16-byte aligned, so the scalar path
SVRG_MIX_MISALIGNED = [1000, 8 * 1024]
SVRG_ALPHAS = [0.0, 0.05, 1.0]
# (w_self, w_up, w_down, thresh): the reference's cases (tests/test_kernels)
MIX_CASES = [(1.0, 0.0, 0.0, 0.0), (1 / 3, 1 / 3, 1 / 3, 0.01),
             (0.5, 0.25, 0.25, 0.3)]
# rows of 1024 timed: the bench's shape (40 MiB for svrg_step, under the
# card's 50 MB L2, so repeated calls may be served from L2 and beat the
# memory bound) and 16384 rows (64 MiB per stream), well over the L2
SVRG_MIX_TIMED_ROWS = [2048, 16384]
SVRG_FLOPS, MIX_FLOPS = 4, 8       # per element (mix: 3 mul, 2 add, prox 3)


def _flat_operands(n: int, count: int, seed: int, device, offset: int = 0):
    """``count`` float32 buffers of n elements from a seed; with ``offset``
    each is a view that starts ``offset`` elements into a larger buffer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        base = torch.as_tensor(rng.normal(size=n + offset),
                               dtype=torch.float32, device=device)
        out.append(base[offset:])
    return out


def check_svrg_mix(device) -> tuple:
    """Every case must equal the plain version exactly.  Returns (the max
    abs err of each kernel over its cases, the timing rows by (kernel,
    rows))."""
    cases = 0
    max_err = {"svrg_step": 0.0, "mix_prox": 0.0}
    shapes = [(n, 0) for n in SVRG_MIX_LENGTHS] + \
        [(n, 1) for n in SVRG_MIX_MISALIGNED]
    for n, offset in shapes:
        x, gn, gs, mu = _flat_operands(n, 4, n + offset, device, offset)
        for alpha in SVRG_ALPHAS:
            alpha_dev = torch.tensor([alpha], dtype=torch.float32,
                                     device=device)[0]
            plain = ref.svrg_step_ref(x, gn, gs, mu, alpha)
            for a in (alpha, alpha_dev):
                out = ops.svrg_step(x, gn, gs, mu, a)
                err = float((out - plain).abs().max())
                if not torch.equal(out, plain):
                    fail(f"svrg_step differs from its plain version: n={n} "
                         f"offset={offset} alpha={alpha} "
                         f"({type(a).__name__}), max abs err {err}")
                max_err["svrg_step"] = max(max_err["svrg_step"], err)
                cases += 1
        for w_s, w_u, w_d, th in MIX_CASES:
            out = ops.mix_prox(x, gn, gs, w_s, w_u, w_d, th)
            plain = ref.mix_prox_ref(x, gn, gs, w_s, w_u, w_d, th)
            err = float((out - plain).abs().max())
            if not torch.equal(out, plain):
                fail(f"mix_prox differs from its plain version: n={n} "
                     f"offset={offset} case={(w_s, w_u, w_d, th)}, max abs "
                     f"err {err}")
            max_err["mix_prox"] = max(max_err["mix_prox"], err)
            cases += 1
    print(f"svrg_mix: all {cases} cases equal to the plain version (max abs "
          f"err 0)", flush=True)

    rows = {}
    alpha, (w_s, w_u, w_d, th) = 0.05, MIX_CASES[1]
    for n_rows in SVRG_MIX_TIMED_ROWS:
        x, gn, gs, mu = (t.reshape(n_rows, 1024) for t in _flat_operands(
            n_rows * 1024, 4, n_rows, device))
        n = x.numel()
        a = torch.tensor([alpha], dtype=torch.float32, device=device)[0]

        def unfused():
            q = x - a * (gn - gs + mu)
            return torch.sign(q) * torch.clamp_min(torch.abs(q) - th, 0.0)

        unfused_ms = graph_ms(unfused)
        for name, kern, plain_fn, streams, flops in (
                ("svrg_step", lambda: ops.svrg_step(x, gn, gs, mu, a),
                 lambda: ref.svrg_step_ref(x, gn, gs, mu, a), 5, SVRG_FLOPS),
                ("mix_prox", lambda: ops.mix_prox(x, gn, gs, w_s, w_u, w_d,
                                                  th),
                 lambda: ref.mix_prox_ref(x, gn, gs, w_s, w_u, w_d, th), 4,
                 MIX_FLOPS)):
            bnd, bnd_by = bound(streams * n * 4, flops * n)
            row = {"kernel": name, "shape": [n_rows, 1024],
                   "max_abs_err": float((kern() - plain_fn()).abs().max()),
                   "ms": graph_ms(kern), "call_ms": time_ms(kern),
                   "plain_ms": graph_ms(plain_fn), "library_ms": None,
                   "bound_ms": bnd, "bound_by": bnd_by,
                   "unfused_chain_ms": unfused_ms,
                   "l2_resident": streams * n * 4 < 50e6}
            row["share_of_bound"] = bnd / row["ms"]
            rows[(name, n_rows)] = row
            print("svrg_mix_case " + json.dumps(row), flush=True)
    return max_err, rows


# ---------------------------------------------------------------------------
# phase 5: plain vs fused DPSVRG step, for kernel="auto"
# ---------------------------------------------------------------------------

def time_auto(device) -> None:
    m, n_local = 8, 64
    for d in AUTO_DIMS:
        rng = np.random.default_rng(d)
        feats = rng.normal(size=(m, n_local, d)).astype(np.float32)
        feats *= 3.0 / np.linalg.norm(feats, axis=2, keepdims=True)
        data = params_from_numpy(
            {"features": feats,
             "labels": (rng.random((m, n_local)) < 0.5).astype(np.float32)},
            device)
        x0 = params_from_numpy(
            0.01 * rng.normal(size=(m, d)).astype(np.float32), device)
        problem = algorithm.Problem(logreg_loss, prox.l1(0.01), x0, data)
        algo = algorithm.dpsvrg_algorithm(
            problem, algorithm.DPSVRGHyperParams())
        state = algo.outer(algo.init())
        batch = {k: v[:, :1].contiguous() for k, v in data.items()}
        phi = torch.as_tensor(graphs.ring_matrix(m), dtype=torch.float32,
                              device=device)
        alpha = torch.tensor([0.01], dtype=torch.float32, device=device)[0]
        steps = {"plain": algo.step, "fused": algo.meta.fused_step("fused")}
        a = steps["plain"](state, batch, phi, alpha).params
        b = steps["fused"](state, batch, phi, alpha).params
        torch.testing.assert_close(b, a, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        # the two steps differ only in the update after the gradients:
        # time it alone too, on the step's own gradients
        grad = algorithm.build_node_grad_fn(logreg_loss)
        g_now = grad(state.params, batch)
        g_snap = grad(state.est.snapshot, batch)
        mu = state.est.full_grad
        updates = {
            "plain": lambda: algorithm.prox_gossip_update(
                state.params, g_now - g_snap + mu, phi, alpha, problem.prox),
            "fused": lambda: ops.fused_resident_step(
                phi, state.params, (g_now, g_snap, mu), alpha, 0.01,
                rule="svrg", prox_kind="l1")}
        # eager, as the resident runner calls them; timed in turns (plain,
        # fused, fused, plain) and averaged per kind
        times = {f"{kind}_{what}_ms": [] for kind in steps
                 for what in ("step", "update")}
        for kind in ("plain", "fused", "fused", "plain"):
            fn = steps[kind]
            times[f"{kind}_step_ms"].append(
                time_ms(lambda: fn(state, batch, phi, alpha)))
            times[f"{kind}_update_ms"].append(time_ms(updates[kind]))
        row = {"d": d, "m": m}
        row.update({k: statistics.mean(v) for k, v in times.items()})
        row["each"] = times
        # kernel="auto" decides on the update: the gradients are the same
        row["fused_wins"] = row["fused_update_ms"] < row["plain_update_ms"]
        print("auto_step " + json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# phase 6: the main path at full width
# ---------------------------------------------------------------------------

def max_graphs(meta, record_every: int) -> int:
    """ceil(log2(longest chunk)) + 1: the most CUDA graphs a resident run
    of ``meta`` at ``record_every`` may build (a chunk never outruns a
    record interval, an inner round or the run)."""
    longest = (max(meta.outer_lengths) if meta.outer_lengths is not None
               else meta.num_steps)
    if record_every:
        longest = min(longest, record_every)
    return math.ceil(math.log2(longest)) + 1


def check_graphs(name: str, extras: dict, bound: int) -> None:
    """A resident run on the card replays CUDA graphs, at most ``bound``."""
    if extras["replays"] < 1:
        fail(f"{name}: the resident run replayed no CUDA graph")
    if not 1 <= extras["graphs_built"] <= bound:
        fail(f"{name}: {extras['graphs_built']} CUDA graphs built, at most "
             f"{bound} allowed")


def main_path_runs(device, parts, dim, kernel_mode, sampling="host"):
    """DPSVRG then DSPG with the same step count, resident, on ``device``,
    minibatches drawn by ``sampling``.  Returns [(name, result, steps,
    launches, seconds, most graphs)]."""
    cfg = paper_logreg.CONFIG
    m = cfg.num_nodes
    data = params_from_numpy(parts, device)
    x0 = gossip.stack_tree(torch.zeros(dim, device=device), m).contiguous()
    problem = algorithm.Problem(logreg_loss, prox.l1(cfg.lam), x0, data)
    sched = graphs.b_connected_ring_schedule(m, 1)
    spec = ExecSpec(resident=True, kernel=kernel_mode, gossip="dense",
                    sampling=sampling, device=device)
    dp = algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=cfg.alpha, beta=cfg.beta, n0=cfg.n0, num_outer=30))
    steps = sum(dp.meta.outer_lengths)
    ds = algorithm.dspg_algorithm(
        problem, algorithm.DSPGHyperParams(alpha0=cfg.alpha), steps)
    out = []
    for name, algo, every in (("dpsvrg", dp, 0), ("dspg", ds, 50)):
        before = ops.launches
        t0 = time.perf_counter()
        res = runner.run(algo, problem, sched, spec, seed=0,
                         record_every=every)
        if device != "cpu":
            torch.cuda.synchronize()
        out.append((name, res, steps, ops.launches - before,
                    time.perf_counter() - t0, max_graphs(algo.meta, every)))
    return out


def check_history(name, res) -> None:
    h = res.history
    for col in ("objective", "consensus"):
        if not np.all(np.isfinite(getattr(h, col))):
            fail(f"{name}: non-finite {col}")
    if not torch.isfinite(res.params).all():
        fail(f"{name}: non-finite parameters")
    if not h.objective[-1] < h.objective[0]:
        fail(f"{name}: the objective did not fall "
             f"({h.objective[0]} -> {h.objective[-1]})")


def profile_main_path(parts, dim: int, sampling="host") -> dict:
    """Where the card's time goes on the main path: a resident DPSVRG run at
    full width (10 outer rounds, minibatches drawn by ``sampling``) traced
    by ``torch.profiler`` after a warm run.  The device's busy time is the
    union of its kernels' intervals; the idle share is the rest of the
    traced run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    cfg = paper_logreg.CONFIG
    m = cfg.num_nodes
    data = params_from_numpy(parts, "cuda")
    x0 = gossip.stack_tree(torch.zeros(dim, device="cuda"), m).contiguous()
    problem = algorithm.Problem(logreg_loss, prox.l1(cfg.lam), x0, data)
    algo = algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=cfg.alpha, beta=cfg.beta, n0=cfg.n0, num_outer=10))
    sched = graphs.b_connected_ring_schedule(m, 1)
    spec = ExecSpec(resident=True, kernel="fused", gossip="dense",
                    sampling=sampling)
    runner.run(algo, problem, sched, spec, record_every=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = runner.run(algo, problem, sched, spec, record_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check_graphs("profile", res.extras, max_graphs(algo.meta, 0))
    steps = sum(algo.meta.outer_lengths)
    out = {"steps": steps, "graphs_built": res.extras["graphs_built"],
           "replays": res.extras["replays"],
           "capture_s": res.extras["capture_s"]}
    out.update(device_busy(prof, wall_us))
    out["kernels_per_step"] = out["device_kernels"] / steps
    return out


def device_busy(prof, wall_us: float) -> dict:
    """The card's busy time in a traced window: the union of its kernels'
    intervals; the idle share is the rest of the window's wall time."""
    # a record_function span (the runner's resident.* spans) also shows on
    # the device's timeline, as a user annotation of the same name: it is
    # not device work
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    annotations = {e.name for e in prof.events() if e.device_type == cpu
                   and getattr(e, "is_user_annotation", False)}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == cuda and e.name not in annotations
                   and not getattr(e, "is_user_annotation", False))
    busy, end, by_name = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        by_name[name] = by_name.get(name, 0.0) + (stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_kernels": len(spans),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": (1.0 - busy / wall_us) if spans else None,
            "top_kernels_ms": {name[:60]: us / 1e3 for name, us in top}}


# ---------------------------------------------------------------------------
# phase 8: the kernel bench, DVR on the banded stack, DSPG through "auto"
# ---------------------------------------------------------------------------

BENCH_SCALE = 1.0      # the whole adult_like set for the paper-scale rows
DVR_STEPS = 40
DSPG_AUTO_STEPS = 600


def _reset_launches() -> None:
    ops.launches = ops.launches_svrg_step = ops.launches_mix_prox = 0
    ops.launches_cells = rn_ops.launches = fa_ops.launches = 0


def _launch_counts() -> dict:
    return {"fused_step": ops.launches, "svrg_step": ops.launches_svrg_step,
            "mix_prox": ops.launches_mix_prox, "rmsnorm": rn_ops.launches,
            "flash_attention": fa_ops.launches,
            "fused_step_cells": ops.launches_cells}


def _held_to_cpu(name: str, card, cpu) -> float:
    """Assert a card history equals the CPU run's; returns the max abs
    difference of the objective."""
    card, cpu = np.asarray(card), np.asarray(cpu)
    np.testing.assert_allclose(card, cpu, rtol=HISTORY_RTOL,
                               atol=HISTORY_ATOL,
                               err_msg=f"{name}: card vs CPU")
    return float(np.max(np.abs(card - cpu)))


def kernel_bench_phase() -> dict:
    """Phase 8.  Returns the launch counts of the bench run and the rows."""
    t0 = time.perf_counter()
    _reset_launches()
    rows = pt_kernel_bench.run(scale=BENCH_SCALE, device="cuda")
    torch.cuda.synchronize()
    counts = _launch_counts()
    bench_s = time.perf_counter() - t0
    calls = {"svrg_step": 0, "mix_prox": 0}
    for r in rows:
        for k, v in r.data.get("calls", {}).items():
            calls[k] += v
    for k, want in calls.items():
        if counts[k] != want:
            fail(f"kernel bench: {counts[k]} {k} launches, the bench made "
                 f"{want} calls")
    if counts["fused_step"] == 0:
        fail("kernel bench: fused_step was never launched")
    by_name = {r.name: r for r in rows}
    errs = by_name["kernel/svrg_mix_check"].data["max_abs_err"]
    if any(v != 0.0 for v in errs.values()):
        fail(f"kernel bench: kernels differ from their plain versions "
             f"{errs}")
    ps = by_name["kernel/resident_paper_scale_auto"].data
    ld = by_name["kernel/resident_large_d_fused"].data
    mv = by_name["kernel/resident_large_d_moving"].data
    for sec, every in ((ps, 100), (ld, 20), (mv, 20)):
        if sec["fused_launches"] != sec["steps"]:
            fail(f"kernel bench {sec['algorithm']}: {sec['fused_launches']} "
                 f"fused_step launches for {sec['steps']} steps")
        check_graphs(f"kernel bench {sec['algorithm']}", sec,
                     math.ceil(math.log2(min(every, sec["steps"]))) + 1)
    if mv["nonzero"] == 0:
        fail("kernel bench: the moving large-d run never left 0")
    t1 = time.perf_counter()
    cpu = pt_kernel_bench.kernel_stats(BENCH_SCALE, "cpu", timed=False)
    cpu_s = time.perf_counter() - t1
    diffs = {}
    for key, sec in (("paper_scale", ps), ("large_d", ld),
                     ("large_d_moving", mv)):
        for kind, hist in sec["objective"].items():
            diffs[f"{key}/{kind}"] = _held_to_cpu(
                f"{key} {kind}", hist, cpu[key]["objective"][kind])
    summary = {
        "launches": counts, "calls": calls, "bench_s": bench_s,
        "cpu_reference_s": cpu_s, "max_abs_objective_vs_cpu": diffs,
        "rows": [{"name": r.name, "us_per_call": r.us_per_call,
                  "derived": r.derived} for r in rows],
        "paper_scale": {k: v for k, v in ps.items() if k != "objective"},
        "large_d": {k: v for k, v in ld.items() if k != "objective"},
        "large_d_moving": {k: v for k, v in mv.items() if k != "objective"},
    }
    print("kernel_bench " + json.dumps(summary), flush=True)
    return summary


def profile_large_d() -> dict:
    """Where the banded d = 131,072 fused run's time goes: one run of the
    bench's loopless DPSVRG traced by ``torch.profiler`` after a warm run.
    Besides the card's busy time, the runner's own spans split the host's
    wall time: the plan (minibatch indices, gossip products), the staging
    copy, issuing the pieces (graph replays, captures and the transitions
    between them), and the history pull."""
    from torch.profiler import ProfilerActivity, profile

    problem = pt_kernel_bench.large_problem("cuda")
    sched = pt_kernel_bench._circulant8()
    spec = ExecSpec(resident=True, kernel="fused", gossip="banded")

    def make():
        return algorithm.loopless_dpsvrg_algorithm(
            problem, 0.05, 40, consensus_rounds=1, batch_size=1)

    runner.run(make(), problem, sched, spec, record_every=20)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = runner.run(make(), problem, sched, spec, record_every=20)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check_graphs("profile_large_d", res.extras, max_graphs(make().meta, 20))
    out = {"steps": 40, "graphs_built": res.extras["graphs_built"],
           "replays": res.extras["replays"]}
    out.update(device_busy(prof, wall_us))
    spans = {}
    for e in prof.events():
        if (e.name.startswith("resident.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            spans[e.name] = spans.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    out["host_spans_ms"] = spans
    return out


def _counted_run(algo, problem, sched, spec, record_every):
    torch.cuda.synchronize()
    before = ops.launches
    t0 = time.perf_counter()
    res = runner.run(algo, problem, sched, spec, seed=0,
                     record_every=record_every)
    torch.cuda.synchronize()
    return res, ops.launches - before, time.perf_counter() - t0


def dvr_and_auto_phase() -> None:
    """DVR fused on the banded d = 131,072 stack, at the reference bench's
    l1 weight and at ``pt_kernel_bench.MOVING_LAM`` (where the iterate
    moves: there the fused run is also held to the plain one on the card,
    and its nonzero parameters are counted), and DSPG on the paper's b=1
    ring with the default ``gossip="auto"``; each against its CPU run."""
    sched = pt_kernel_bench._circulant8()
    out = {}

    def dvr(lam):
        def make(device):
            problem = pt_kernel_bench.large_problem(device, lam=lam)
            return (algorithm.dvr_algorithm(problem, 0.05, DVR_STEPS,
                                            rho=0.5), problem)
        return make

    data, _, h, x0, _ = pt_common.setup_problem("adult_like", BENCH_SCALE,
                                                device="cuda")
    ring = graphs.b_connected_ring_schedule(8, 1)

    def dspg(device):
        if device == "cuda":
            problem = algorithm.Problem(logreg_loss, h, x0, data)
        else:
            problem = algorithm.Problem(
                logreg_loss, h, x0.cpu(),
                {k: v.cpu() for k, v in data.items()})
        return (algorithm.dspg_algorithm(
            problem, algorithm.DSPGHyperParams(alpha0=0.2),
            DSPG_AUTO_STEPS), problem)

    for name, make, schedule, spec_kw, every in (
            ("dvr_banded_fused", dvr(0.01), sched, dict(gossip="banded"), 20),
            ("dvr_banded_moving", dvr(pt_kernel_bench.MOVING_LAM), sched,
             dict(gossip="banded"), 20),
            ("dspg_ring_auto", dspg, ring, {}, 100)):
        algo, problem = make("cuda")
        spec = ExecSpec(resident=True, kernel="fused", **spec_kw)
        backend = transport.resolve_backend(spec.gossip, schedule, algo.meta)
        if name == "dspg_ring_auto" and backend.name != "banded":
            fail(f"gossip='auto' picked {backend.name!r} for DSPG on the "
                 f"b=1 ring, not 'banded'")
        res, launches, secs = _counted_run(algo, problem, schedule, spec,
                                           every)
        steps = int(res.history.steps[-1])
        if launches != steps:
            fail(f"{name}: {launches} fused_step launches for {steps} steps")
        check_graphs(name, res.extras, max_graphs(algo.meta, every))
        calgo, cproblem = make("cpu")
        cres = runner.run(calgo, cproblem, schedule,
                          spec.replace(device="cpu"), seed=0,
                          record_every=every)
        np.testing.assert_array_equal(res.extras["wire_bytes"],
                                      cres.extras["wire_bytes"])
        diff = _held_to_cpu(name, res.history.objective,
                            cres.history.objective)
        out[name] = {"backend": backend.name, "steps": steps,
                     "launches": launches, "run_s": secs,
                     "ms_per_step": secs / steps * 1e3,
                     "graphs_built": res.extras["graphs_built"],
                     "replays": res.extras["replays"],
                     "capture_s": res.extras["capture_s"],
                     "transfers_h2d": res.extras["transfers_h2d"],
                     "transfers_d2h": res.extras["transfers_d2h"],
                     "wire_bytes_last": int(res.extras["wire_bytes"][-1]),
                     "objective_first": float(res.history.objective[0]),
                     "objective_last": float(res.history.objective[-1]),
                     "nonzero": int(torch.count_nonzero(res.params)),
                     "params": res.params.numel(),
                     "max_abs_objective_vs_cpu": diff}
        if name == "dvr_banded_moving":
            if out[name]["nonzero"] == 0:
                fail(f"{name}: the iterate never left 0")
            palgo, _ = make("cuda")
            plain = runner.run(palgo, problem, schedule,
                               spec.replace(kernel="plain"), seed=0,
                               record_every=every)
            np.testing.assert_allclose(
                res.history.objective, plain.history.objective,
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name}: fused vs plain on the card")
            out[name]["max_abs_objective_fused_vs_plain"] = float(np.max(
                np.abs(res.history.objective - plain.history.objective)))
        print(f"{name} " + json.dumps(out[name]), flush=True)


# ---------------------------------------------------------------------------
# phase 9: RMSNorm and flash attention against their plain versions
# ---------------------------------------------------------------------------

# Kernel on the card vs plain version on the card.  float32: the same
# formula summed in other orders (a block reduction of x^2 in RMSNorm; FMA
# dot products and an online softmax in flash, cuBLAS and a full softmax in
# the plain version); 2e-5 is the reference's own tolerance for its flash
# kernel (tests/test_kernels.py).  bf16 RMSNorm: both round a float32
# value to bf16 and may land on neighbouring values, one bf16 ulp apart,
# at most 2^-7 = 7.8e-3 of the value.  bf16 flash: held element by element
# to ``fa_ref.bf16_bound`` against the plain version on the float32 values
# of the same bf16 inputs; the bound follows where the kernel rounds (P to
# bf16 before P V, the output to bf16).
RMS_F32_TOL = dict(rtol=1e-5, atol=1e-5)
RMS_BF16_TOL = dict(rtol=8e-3, atol=1e-5)
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-5)
RMS_ROWS = [1, 3, 4, 8, 6144]
# widths around the kernel's register tiles: ragged (1, 7: the scalar
# two-pass path), the smoke variants' 128, the models' 2304 (minicpm), 2560
# (h2o-danube), 3584 (gemma2) and 5120 (the llama4 configs), and the first
# width past the widest row held in registers (two passes; 10,248 float32,
# 20,488 bf16)
RMS_DIMS = [1, 7, 128, 2304, 2560, 3584, 5120, "register+8"]
# the shape of the kernels line: a decode step of the serving path (4 slots)
RMS_LINE_SHAPE = (4, 2560)
# the block norms of phases 25-26, float32: xlstm-350m (d 1024) and
# jamba-1.5-large (d 8192) at a 4-slot decode step and at a long prefill
# (512 tokens, four times xlstm's longest served prompt; jamba's longest,
# 2048)
RMS_SSM_SHAPES = [(4, 1024), (512, 1024), (4, 8192), (2048, 8192)]
# llava-next-mistral-7b's norms (d 4096, phase 28), float32: a 4-slot
# decode step and its longest prefill (the 1152-token image prefix and a
# 2048-token prompt)
RMS_LLAVA_SHAPES = [(4, 4096), (3200, 4096)]
# b, h, kv, sq, sk, hd, causal, window, softcap: the prefills of 6144
# tokens of h2o-danube-1.8b, stablelm-12b (head_dim 160) and scout's global
# NoPE layer (head_dim 128)
DANUBE_FLASH_CASE = (1, 32, 8, 6144, 6144, 80, True, 4096, None)
STABLELM_FLASH_CASE = (1, 32, 8, 6144, 6144, 160, True, None, None)
SCOUT_FLASH_CASE = (1, 40, 8, 6144, 6144, 128, True, None, None)
# jamba-1.5-large's attention layer at its longest prefill of phase 26
JAMBA_FLASH_CASE = (1, 64, 8, 2048, 2048, 128, True, None, None)
# the decoders' causal self-attention at the longest prefills of phases
# 27-28: whisper-base (MHA, head_dim 64) on a 224-token prompt, and
# llava-next-mistral-7b (GQA 4x, head_dim 128) on its 1152-token image
# prefix and a 2048-token prompt
WHISPER_FLASH_CASE = (1, 8, 8, 224, 224, 64, True, None, None)
LLAVA_FLASH_CASE = (1, 32, 8, 3200, 3200, 128, True, None, None)
FLASH_CASES = [
    (1, 4, 2, 128, 128, 64, True, None, None),      # GQA 2x, causal
    (2, 4, 4, 256, 256, 32, True, None, None),      # MHA, batch 2
    (1, 8, 2, 128, 128, 64, True, 64, None),        # GQA 4x + window
    (1, 2, 1, 128, 256, 64, True, None, 50.0),      # softcap, sk > sq
    (1, 4, 2, 100, 100, 80, True, None, None),      # ragged q and k, hd 80
    (1, 4, 2, 77, 130, 80, False, None, None),      # bidirectional, ragged
    (1, 4, 4, 200, 200, 128, False, 37, None),      # bidirectional + window
    (1, 4, 2, 300, 300, 256, True, 100, 50.0),      # gemma2's head_dim 256
    (1, 4, 2, 130, 130, 33, True, None, None),      # hd % 4 != 0: loads
    DANUBE_FLASH_CASE, STABLELM_FLASH_CASE, SCOUT_FLASH_CASE,
    JAMBA_FLASH_CASE, WHISPER_FLASH_CASE, LLAVA_FLASH_CASE,
]


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """(bound ms, what bounds it): bytes at the memory rate or operations
    at the card's peak rate for their type, whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sass() -> dict:
    """HGMMA (wgmma) instructions in the built flash library, counted in
    ``cuobjdump -sass``: the toolkit's, else one on PATH, else the one in
    Triton's package.  Says why where none is found."""
    lib = _build.library_path(fa_kernel.SOURCE)
    tools = [os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump"),
             shutil.which("cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    found = [t for t in tools if t and os.access(t, os.X_OK)]
    if not found:
        return {"library": lib.name, "cuobjdump": None,
                "why": "no cuobjdump beside nvcc, on PATH or in Triton's "
                       "package"}
    proc = subprocess.run([found[0], "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        fail(f"{found[0]} -sass {lib.name}: {proc.stderr.strip()}")
    sass = proc.stdout.splitlines()
    return {"library": lib.name, "cuobjdump": found[0],
            "hgmma": sum("HGMMA" in ln for ln in sass),
            "kernels": sum("Function :" in ln for ln in sass)}


def _rmsnorm_case(n: int, d: int, dtype, gen, device) -> dict:
    x = torch.randn(n, d, generator=gen, device=device).to(dtype)
    w = (0.1 * torch.randn(d, generator=gen, device=device)).to(dtype)
    out = rn_ops.rmsnorm(x, w)
    plain = rn_ref.rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    tol = RMS_F32_TOL if dtype == torch.float32 else RMS_BF16_TOL
    torch.testing.assert_close(out, plain, **tol)
    err = float((out.float() - plain.float()).abs().max())
    w1 = 1.0 + w
    es = x.element_size()
    bnd, bnd_by = bound((2 * n * d + d) * es, 4 * n * d, dtype)

    def kern():
        return rn_ops.rmsnorm(x, w)

    def plain_fn():
        return rn_ref.rmsnorm_ref(x, w)

    buf = torch.empty_like(x)
    row = {"shape": [n, d], "dtype": str(dtype).split(".")[-1],
           "max_abs_err": err,
           "ms": graph_ms(kern), "call_ms": time_ms(kern),
           "plain_ms": graph_ms(plain_fn),
           "library_ms": graph_ms(lambda: F.rms_norm(x, (d,), w1, 1e-6)),
           # the memory rate's yardstick: x copied, the same bytes less
           # w's (timed only)
           "copy_ms": graph_ms(lambda: buf.copy_(x)),
           "bound_ms": bnd, "bound_by": bnd_by}
    row["share_of_bound"] = bnd / row["ms"]
    print("rmsnorm_case " + json.dumps(row), flush=True)
    return row


def check_rmsnorm(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(7)
    rows_out = {}
    cases = [(n, width, dtype) for width in RMS_DIMS for n in RMS_ROWS
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(n, d, torch.float32)
              for n, d in RMS_SSM_SHAPES + RMS_LLAVA_SHAPES]
    for n, width, dtype in cases:
        d = width if width != "register+8" else \
            rn_kernel.max_register_d(dtype) + 8
        row = _rmsnorm_case(n, d, dtype, gen, device)
        rows_out[(n, d, row["dtype"])] = row
    return rows_out


def check_flash(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(8)
    rows_out = {}
    for case in FLASH_CASES:
        b, h, kv, sq, sk, hd, causal, win, cap = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                                   device=device).to(dtype)
                       for s, n in ((sq, h), (sk, kv), (sk, kv)))
            kw = dict(causal=causal, sliding_window=win, softcap=cap)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            out = fa_ops.flash_attention(q, k, v, **kw)
            over = None   # bf16: the largest share of its bound
            if dtype == torch.float32:
                plain = fa_ref.attention_ref(qt, kt, vt, **kw).transpose(1, 2)
                torch.cuda.synchronize()
                torch.testing.assert_close(out, plain, **FLASH_F32_TOL)
                err = float((out - plain).abs().max())
            else:
                plain, limit = fa_ref.bf16_bound(qt, kt, vt, **kw)
                torch.cuda.synchronize()
                diff = (out.float() - plain.transpose(1, 2)).abs()
                over = float((diff / limit.transpose(1, 2)).max())
                err = float(diff.max())
                if not over <= 1.0:
                    fail(f"flash {case} bf16: error {err:.3g} reaches "
                         f"{over:.3g}x its element-wise bound")
                del limit, diff
            del plain
            ok = fa_ref.mask(sq, sk, causal=causal, sliding_window=win,
                             device=device)
            pairs = int(ok.sum())
            es = q.element_size()
            bnd, bnd_by = bound((2 * b * sq * h + 2 * b * sk * kv) * hd * es,
                                4 * hd * pairs * h * b, dtype)

            def kern():
                return fa_ops.flash_attention(q, k, v, **kw)

            def plain_fn():
                return fa_ref.attention_ref(qt, kt, vt, **kw)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=ok, enable_gqa=True)

            row = {"case": list(case), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "max_err_over_bound": over,
                   "pairs": pairs,
                   "ms": graph_ms(kern),
                   "call_ms": time_ms(kern, iters=None),
                   "plain_ms": graph_ms(plain_fn),
                   # the library has no softcap: no call computes that case
                   "library_ms": None if cap is not None
                   else graph_ms(library),
                   "bound_ms": bnd, "bound_by": bnd_by}
            row["share_of_bound"] = bnd / row["ms"]
            rows_out[(case, row["dtype"])] = row
            print("flash_case " + json.dumps(row), flush=True)
            del q, k, v, qt, kt, vt, ok
            torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# phase 10: h2o-danube-1.8b in bf16 through the bf16 flash kernel
# ---------------------------------------------------------------------------

DANUBE_SEED = 0
DANUBE_BF16_PROMPTS = [2048, 6144]
# Both paths round the activations and P to bf16; the plain path also
# rounds the attention logits to bf16, the kernel path keeps them in
# float32, and RMSNorm sums in its own order.  Both errors against the
# float32 path are bf16 rounding compounded through 24 layers, of one
# order; a broken kernel gives errors of order 1.
BF16_ERR_RATIO = 1.5


def _prefill_ms(cfg, params, toks):
    """(last logits as float32, ms) of a prefill, timed on the host clock
    after one untimed call at the same length (first calls at a new shape
    pay for the allocator and the libraries' set-up).  The kernels' launch
    counts are set to 0 between the two calls: they count the timed one."""
    transformer.prefill(cfg, params, toks, max_len=toks.shape[1])
    torch.cuda.synchronize()
    fa_ops.launches = rn_ops.launches = 0
    t0 = time.perf_counter()
    logits, _ = transformer.prefill(cfg, params, toks,
                                    max_len=toks.shape[1])
    torch.cuda.synchronize()
    return logits.float(), (time.perf_counter() - t0) * 1e3


def danube_bf16_prefill() -> dict:
    """Phase 10: bf16 prefills of h2o-danube-1.8b at full width on the
    kernel path (the bf16 flash and RMSNorm kernels) and the plain path,
    both held to the float32 kernel path on the same weights."""
    cfg = configs.get_config("h2o-danube-1.8b").scaled(
        param_dtype="bfloat16", use_flash=True, use_fused_norm=True)
    plain_cfg = cfg.scaled(use_flash=False, use_fused_norm=False)
    f32_cfg = cfg.scaled(param_dtype="float32")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, DANUBE_SEED, device=SERVE_DEVICE)
    params32 = pytree.tree_map(lambda t: t.float(), params)
    torch.cuda.synchronize()
    print(f"danube bf16: {transformer.param_count(params)} parameters "
          f"(bf16, and a float32 copy) on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(DANUBE_SEED)
    result = {"launches": {"flash_attention": 0, "rmsnorm": 0},
              "prompts": {}}
    for n in DANUBE_BF16_PROMPTS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=n)
                               .astype(np.int32), device=SERVE_DEVICE)[None]
        # the bf16 kernel path: counts set to 0 just before the timed
        # prefill, read just after
        lk, kernel_ms = _prefill_ms(cfg, params, toks)
        flash_n, rms_n = fa_ops.launches, rn_ops.launches
        if (flash_n, rms_n) != (cfg.num_layers, 2 * cfg.num_layers + 1):
            fail(f"danube bf16 {n}: {flash_n} flash and {rms_n} rmsnorm "
                 f"launches, want {cfg.num_layers} and "
                 f"{2 * cfg.num_layers + 1}")
        result["launches"]["flash_attention"] += flash_n
        result["launches"]["rmsnorm"] += rms_n
        lp, plain_ms = _prefill_ms(plain_cfg, params, toks)
        lr, f32_ms = _prefill_ms(f32_cfg, params32, toks)
        for name, lg in (("kernel", lk), ("plain", lp), ("float32", lr)):
            if not bool(torch.isfinite(lg).all()) or \
                    tuple(lg.shape) != (1, cfg.vocab_size):
                fail(f"danube bf16 {n}: {name} path logits of shape "
                     f"{tuple(lg.shape)}, not all finite")
        kerr = float((lk - lr).abs().max())
        perr = float((lp - lr).abs().max())
        row = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "float32_kernel_ms": f32_ms,
               "max_abs_logit_err_kernel": kerr,
               "max_abs_logit_err_plain": perr,
               "err_ratio": kerr / perr,
               "flash_launches": flash_n, "rmsnorm_launches": rms_n,
               "greedy_kernel_vs_float32": int(lk.argmax()) ==
               int(lr.argmax())}
        result["prompts"][str(n)] = row
        print(f"danube_bf16_prefill_{n} " + json.dumps(row), flush=True)
        if not kerr <= BF16_ERR_RATIO * perr:
            fail(f"danube bf16 {n}: kernel path logit error {kerr:.3g} "
                 f"exceeds {BF16_ERR_RATIO}x the plain path's {perr:.3g}")
        del lk, lp, lr
    del params, params32
    torch.cuda.empty_cache()
    print("danube_bf16_prefill " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phases 11-13: serving h2o-danube-1.8b at full width
# ---------------------------------------------------------------------------

DANUBE_PROMPTS = [512, 1024, 2048, 3072, 4096, 4608, 5120, 6144]
DANUBE_NEW = 32
DANUBE_SLOTS, DANUBE_MAX_LEN, DANUBE_CHUNK = 4, 6208, 8
SERVE_DEVICE = "cuda"
STREAM_RATE = 2.0          # mean arrivals per second of the replayed stream
# Kernel path (flash + RMSNorm kernels) vs plain path, both on the card, on
# logits of order 1: the same float32 arithmetic summed in other orders
# (online softmax over 64-key tiles, a block reduction in RMSNorm),
# compounded through 24 layers of a 2560-wide residual stream and up to
# 6144 positions; the tolerance keeps three significant digits.
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


class TimedEngine(ResidentEngine):
    """ResidentEngine that times each admission (prefill and splice) and
    each decode chunk, with the card synchronised around each."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prefill_ms: dict[int, float] = {}
        self.chunk_ms: list[float] = []

    def _admit(self, slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._admit(slot, req)
        torch.cuda.synchronize()
        self.prefill_ms[len(req.tokens)] = (time.perf_counter() - t0) * 1e3

    def _run_chunk(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        super()._run_chunk()
        torch.cuda.synchronize()
        self.chunk_ms.append((time.perf_counter() - t0) * 1e3)


def _requests(vocab: int, prompts, new: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, size=n)
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(prompts)]


def danube_requests(vocab: int) -> list:
    return _requests(vocab, DANUBE_PROMPTS, DANUBE_NEW, DANUBE_SEED)


class _DropCounter:
    """Counts the tokens that capacity drops in each MoE routing, split by
    batch size (a decode step routes one token a slot), while installed in
    place of ``moe.route``."""

    def __init__(self):
        self.dropped: dict[int, int] = {}
        self.routed: dict[int, int] = {}
        self._route = moe.route

    def __enter__(self):
        def counted(params, spec, xt):
            out = self._route(params, spec, xt)
            t = int(xt.shape[0])
            self.dropped[t] = self.dropped.get(t, 0) + int(
                (~out[4]).sum())
            self.routed[t] = self.routed.get(t, 0) + out[4].numel()
            return out
        moe.route = counted
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _rmsnorm_sites(cfg, params, toks, max_len) -> dict:
    """One kernel-path prefill with every RMSNorm launch held to its plain
    version on the same input (RMS_BF16_TOL for bf16): the model's own
    activations at each norm site.  Returns the sites and the largest
    error."""
    launch = rn_ops.rmsnorm
    errs = []

    def held(x, w):
        out = launch(x, w)
        plain = rn_ref.rmsnorm_ref(x, w)
        tol = RMS_F32_TOL if x.dtype == torch.float32 else RMS_BF16_TOL
        torch.testing.assert_close(out, plain, **tol)
        errs.append(float((out.float() - plain.float()).abs().max()))
        return out

    rn_ops.rmsnorm = held
    try:
        transformer.prefill(cfg, params, toks, max_len=max_len)
    finally:
        rn_ops.rmsnorm = launch
    return {"sites": len(errs), "max_abs_err": max(errs)}


def _check_served(cfg, params, reqs, outs, *, slots: int, max_len: int,
                  device, compare_logits=True) -> dict:
    """Phase 11's checks of a serving run's tokens ``outs``: the host
    ContinuousBatcher on the same requests gives the same tokens (in an
    MoE model both decode the same rows, so the capacity a decode batch
    shares routes them alike; the drops its routings take are counted);
    then each prompt's prefill and teacher-forced decode on the kernel and
    the plain path: float32 logits within LOGIT_TOL, bf16 logits recorded
    and every RMSNorm site of a prefill held to its plain version.

    ``compare_logits=False`` stops after the tokens: a model whose
    float32 logits the arithmetic does not determine to LOGIT_TOL is held
    elsewhere (xlstm-350m: ``_prefix_check``).  A request's image or audio
    goes to every prefill (``scheduler.modality_inputs``)."""
    host = ContinuousBatcher(cfg, params, max_slots=slots, max_len=max_len)
    for r in reqs:
        host.submit(r)
    with _DropCounter() as drops:
        host_out = host.run_until_done()
    for r in reqs:
        if not np.array_equal(host_out[r.uid], outs[r.uid]):
            fail(f"{cfg.name}: request {r.uid}: resident engine and host "
                 f"batcher tokens differ")
    del host
    _free_card()
    result = {}
    if drops.routed:
        result["moe_dropped"] = {
            f"batch_{t}": {"dropped": drops.dropped[t],
                           "routed": drops.routed[t]}
            for t in sorted(drops.routed)}
    plain_cfg = cfg.scaled(use_flash=False, use_fused_norm=False)
    bf16 = cfg.param_dtype == "bfloat16"
    prefill_err = decode_err = 0.0
    agree = total = 0
    kernel_ms, plain_ms = {}, {}
    if not compare_logits:
        return result
    for r in reqs:
        toks = torch.as_tensor(r.tokens, device=device)[None]
        kw = modality_inputs(cfg, r, max_len, device)
        _sync(device)
        t0 = time.perf_counter()
        lk, ck = transformer.prefill(cfg, params, toks, max_len=max_len,
                                     **kw)
        _sync(device)
        t1 = time.perf_counter()
        lp, cp = transformer.prefill(plain_cfg, params, toks,
                                     max_len=max_len, **kw)
        _sync(device)
        kernel_ms[len(r.tokens)] = (t1 - t0) * 1e3
        plain_ms[len(r.tokens)] = (time.perf_counter() - t1) * 1e3
        if not bool(torch.isfinite(lk).all()) or \
                tuple(lk.shape) != (1, cfg.vocab_size):
            fail(f"{cfg.name}: prefill logits of shape {tuple(lk.shape)}, "
                 f"not all finite")
        if not bf16:
            torch.testing.assert_close(lk, lp, **LOGIT_TOL)
        prefill_err = max(prefill_err, float((lk - lp).abs().max()))
        out = outs[r.uid]
        agree += int(int(lk.argmax()) == int(out[0]))
        total += 1
        for t in range(len(out) - 1):
            tok = torch.tensor([int(out[t])], dtype=torch.int32,
                               device=device)
            lk, ck = transformer.decode_step(cfg, params, ck, tok)
            lp, cp = transformer.decode_step(plain_cfg, params, cp, tok)
            if not bf16:
                torch.testing.assert_close(lk, lp, **LOGIT_TOL)
            decode_err = max(decode_err, float((lk - lp).abs().max()))
            agree += int(int(lk.argmax()) == int(out[t + 1]))
            total += 1
        del ck, cp
    _free_card()
    result.update({
        "prefill_ms": {str(k): v for k, v in sorted(kernel_ms.items())},
        "plain_prefill_ms": {str(k): v for k, v in sorted(plain_ms.items())},
        "max_abs_logit_err_prefill": prefill_err,
        "max_abs_logit_err_decode": decode_err,
        "greedy_batch1_agrees": f"{agree}/{total}"})
    if bf16 and cfg.use_fused_norm:
        toks = torch.as_tensor(reqs[0].tokens, device=device)[None]
        result["rmsnorm_sites"] = _rmsnorm_sites(cfg, params, toks, max_len)
    return result


def serve_model(tag: str, cfg, params, reqs, *, slots: int, max_len: int,
                chunk: int, flash_per_prefill: int, rms_per_forward: int,
                stream: serve_stream.StreamConfig, device=SERVE_DEVICE,
                compare_logits=True, stream_modality=None) -> dict:
    """Serves ``reqs`` through the ResidentEngine (the main path: launch
    counts set to 0 just before and read just after, and exact), holds its
    tokens to the host batcher and its logits to the plain path
    (``_check_served``, with ``compare_logits``), then replays ``stream``
    through the engine (TTFT, TPOT), each stream request with the image or
    audio ``stream_modality(uid)`` gives, where it is given."""
    _free_card()
    _peak_reset(device)
    eng = TimedEngine(cfg, params, max_slots=slots, max_len=max_len,
                      chunk=chunk)
    for r in reqs:
        eng.submit(r)
    rn_ops.launches = 0
    fa_ops.launches = 0
    t0 = time.perf_counter()
    outs = eng.run_until_done()
    _sync(device)
    wall_s = time.perf_counter() - t0
    flash_n, rms_n = fa_ops.launches, rn_ops.launches
    chunks = eng.transfers["chunks"]
    steps_n = chunks * chunk
    want = (flash_per_prefill * len(reqs),
            rms_per_forward * (len(reqs) + steps_n)) \
        if device != "cpu" else (0, 0)
    if (flash_n, rms_n) != want:
        fail(f"{tag}: {flash_n} flash and {rms_n} rmsnorm launches, want "
             f"{want[0]} and {want[1]}")
    if eng.transfers != {"h2d": len(reqs), "d2h": chunks, "chunks": chunks}:
        fail(f"{tag}: transfers {eng.transfers}")
    for r in reqs:
        if len(outs[r.uid]) != r.max_new_tokens:
            fail(f"{tag}: request {r.uid} gave {len(outs[r.uid])} tokens")
    tokens = sum(len(v) for v in outs.values())
    result = {"launches": {"flash_attention": flash_n, "rmsnorm": rms_n},
              "transfers": dict(eng.transfers), "decode_steps": steps_n,
              "wall_s": wall_s, "tokens": tokens,
              "tokens_per_s": tokens / wall_s,
              "engine_prefill_ms": {str(k): v for k, v in
                                    sorted(eng.prefill_ms.items())},
              "chunk_ms": statistics.median(eng.chunk_ms),
              "chunk_ms_each": eng.chunk_ms,
              "decode_step_ms": statistics.median(eng.chunk_ms) / chunk,
              "max_memory_allocated_bytes": _peak(device)}
    del eng
    _free_card()
    result.update(_check_served(cfg, params, reqs, outs, slots=slots,
                                max_len=max_len, device=device,
                                compare_logits=compare_logits))

    stream_reqs = serve_stream.make_requests(stream)
    if stream_modality is not None:
        stream_reqs = [_ModalStreamRequest(**{
            f.name: getattr(r, f.name) for f in dataclasses.fields(r)},
            modality=stream_modality(r.uid)) for r in stream_reqs]
    eng = ResidentEngine(cfg, params, max_slots=slots, max_len=max_len,
                         chunk=chunk)
    summary = serve_metrics.summarize(serve_stream.replay(eng, stream_reqs))
    want = sum(r.max_new_tokens for r in stream_reqs)
    if summary["requests"] != len(stream_reqs) or summary["tokens"] != want:
        fail(f"{tag} stream: {summary['requests']} requests, "
             f"{summary['tokens']} tokens, want {len(stream_reqs)}, {want}")
    result["stream"] = dict(summary, rate=stream.rate)
    del eng
    result["peak_bytes"] = _peak(device)
    _free_card()
    return result


@dataclasses.dataclass(frozen=True)
class _ModalStreamRequest(serve_stream.StreamRequest):
    """A stream request with its image or audio, which ``to_request`` puts
    on the ``Request`` (the stream's own API is the reference's)."""
    modality: dict = dataclasses.field(default_factory=dict)

    def to_request(self) -> Request:
        return dataclasses.replace(super().to_request(), **self.modality)


def danube_weights() -> tuple:
    """(cfg, params): h2o-danube-1.8b at full width on the kernel path,
    float32 weights from a seed on the card (phases 11-12 and 29)."""
    cfg = configs.get_config("h2o-danube-1.8b").scaled(
        use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, DANUBE_SEED, device=SERVE_DEVICE)
    torch.cuda.synchronize()
    print(f"danube: {transformer.param_count(params)} parameters (f32) on "
          f"the card in {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params


def serve_danube(cfg, params) -> dict:
    """Phases 11-12 on ``danube_weights()``.  Returns the numbers of the
    serving run."""
    reqs = danube_requests(cfg.vocab_size)
    # phase 12's stream: a seeded Poisson stream through the same model
    stream = serve_stream.StreamConfig(
        num_requests=8, vocab_size=cfg.vocab_size, arrival="poisson",
        rate=STREAM_RATE, prompt_lens=(512, 2048, 6144), new_low=16,
        new_high=32, seed=DANUBE_SEED)
    result = serve_model("danube", cfg, params, reqs, slots=DANUBE_SLOTS,
                         max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK,
                         flash_per_prefill=cfg.num_layers,
                         rms_per_forward=2 * cfg.num_layers + 1,
                         stream=stream, device=SERVE_DEVICE)
    summary = result.pop("stream")

    # where the card's time goes: one prefill and one decode chunk, traced
    from torch.profiler import ProfilerActivity, profile
    eng = ResidentEngine(cfg, params, max_slots=DANUBE_SLOTS,
                         max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK)
    for r in reqs[:DANUBE_SLOTS]:
        eng.submit(Request(uid=r.uid, tokens=r.tokens[:512],
                           max_new_tokens=64))
    eng._admit_all()
    toks = torch.as_tensor(reqs[2].tokens, device=SERVE_DEVICE)[None]   # 2048
    transformer.prefill(cfg, params, toks, max_len=DANUBE_MAX_LEN)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer.prefill(cfg, params, toks, max_len=DANUBE_MAX_LEN)
        eng._run_chunk()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    result["profile_prefill2048_and_chunk"] = device_busy(prof, wall_us)
    del eng
    _free_card()
    print("danube_serve " + json.dumps(result), flush=True)
    print("danube_stream " + json.dumps(summary), flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 14: fused_step over the cells of a sweep, against single launches
# ---------------------------------------------------------------------------

# the figures' widths (Table I: 784, 1024, 30, 54) and the bench's 131,072;
# grids of 1, 3 (Fig. 4), 4 (Figs. 1 and 5) and 16 cells
CELL_DIMS = [30, 54, 784, 1024, 131072]
CELL_COUNTS = [1, 3, 4, 16]
# the shapes of the kernels line: Fig. 4 and Fig. 5 / Fig. 1 on mnist_like,
# and Fig. 1 on cifar10_like
CELL_TIMED = [(3, 8, 784), (4, 8, 784), (4, 8, 1024)]


def cells_case(cells: int, m: int, d: int, rule: str, seed: int, device,
               w_shared: bool, scalars_shared: bool):
    """Seeded operands of a cell-batched launch: streams (cells, m, d),
    drawn on the card (up to 16 x 8 x 131,072 a stream), W (m, m) or one
    ring product a cell, alpha and lam as Python floats or one value a cell
    on the card."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_streams = 4 if rule == "svrg" else 2
    streams = [torch.randn(cells, m, d, generator=gen, device=device)
               for _ in range(n_streams)]
    ws = [graphs.b_connected_ring_schedule(m, 2, seed=seed + c)
          .consensus_rounds(0, 3) for c in range(1 if w_shared else cells)]
    w = torch.as_tensor(ws[0] if w_shared else np.stack(ws),
                        dtype=torch.float32, device=device)
    if scalars_shared:
        alpha, lam = 0.05, 0.01
    else:
        alpha = torch.as_tensor(rng.uniform(0.01, 0.3, cells),
                                dtype=torch.float32, device=device)
        lam = torch.as_tensor(rng.uniform(1e-3, 0.1, cells),
                              dtype=torch.float32, device=device)
    return w, streams, alpha, lam


def single_launches(w, streams, alpha, lam, rule, prox_kind):
    """The same step as B single-cell launches of ``fused_step_buf``."""
    def pick(v, c):
        return v[c] if isinstance(v, torch.Tensor) else v
    lam_host = lam.tolist() if isinstance(lam, torch.Tensor) else None
    return [ops.fused_step_buf(
        w[c] if w.ndim == 3 else w, [s[c] for s in streams],
        pick(alpha, c), lam if lam_host is None else lam_host[c],
        rule=rule, prox_kind=prox_kind) for c in range(streams[0].shape[0])]


def cells_bound(cells: int, m: int, d: int, rule: str, prox_kind: str,
                w_cells: int):
    """(bound ms, what bounds it) of a cell-batched launch: B times the
    single step's bytes and operations, with ``w_cells`` mixing matrices."""
    n_streams = 4 if rule == "svrg" else 2
    nbytes = (n_streams + 1) * cells * m * d * 4 + w_cells * m * m * 4 \
        + 2 * cells * 4
    flops = cells * (m * d * ((2 if rule == "svrg" else 0) + 2)
                     + 2 * m * m * d
                     + m * d * {"l1": 4, "sql2": 1, "none": 0}[prox_kind])
    return bound(nbytes, flops)


def check_cells_kernel(device) -> dict:
    """Hold the cell-batched launch bitwise to single launches at every
    listed shape, rule, prox and sharing of W and of alpha / lam, then time
    it at ``CELL_TIMED`` (svrg l1, per-cell W, alpha and lam, as a Fig. 5
    sweep calls it) beside its bound, the same cells as single launches, the
    plain version and ``torch.bmm(W, q)``."""
    m, cases = 8, 0
    for d in CELL_DIMS:
        for cells in CELL_COUNTS:
            for rule in ref.FUSED_RULES:
                for prox_kind in ref.FUSED_PROXES:
                    for w_shared in (True, False):
                        for shared in (True, False):
                            w, streams, alpha, lam = cells_case(
                                cells, m, d, rule, cells * d, device,
                                w_shared, shared)
                            out = ops.fused_step_cells_buf(
                                w, streams, alpha, lam, rule=rule,
                                prox_kind=prox_kind)
                            want = torch.stack(single_launches(
                                w, streams, alpha, lam, rule, prox_kind))
                            if not torch.equal(out, want):
                                fail(f"fused_step over {cells} cells differs "
                                     f"from single launches: d={d} {rule} "
                                     f"{prox_kind} w_shared={w_shared} "
                                     f"scalars_shared={shared}")
                            cases += 1
    torch.cuda.synchronize()
    print(f"fused_step_cells: {cases} cases bitwise equal to single "
          f"launches", flush=True)
    rows = {}
    for cells, m, d in CELL_TIMED:
        rule, prox_kind = "svrg", "l1"
        w, streams, alpha, lam = cells_case(cells, m, d, rule, d, device,
                                            False, False)
        plain = ref.fused_step_cells_math(w, streams, alpha, lam, rule=rule,
                                          prox_kind=prox_kind)
        out = ops.fused_step_cells_buf(w, streams, alpha, lam, rule=rule,
                                       prox_kind=prox_kind)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, plain, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        q = streams[0] - alpha[:, None, None] * streams[1]
        bound_ms, bound_by = cells_bound(cells, m, d, rule, prox_kind, cells)
        lam_host = lam.tolist()

        def kern():
            return ops.fused_step_cells_buf(w, streams, alpha, lam,
                                            rule=rule, prox_kind=prox_kind)

        def singles():
            for c in range(cells):
                ops.fused_step_buf(w[c], [s[c] for s in streams], alpha[c],
                                   lam_host[c], rule=rule,
                                   prox_kind=prox_kind)

        row = {"shape": [cells, m, d], "rule": rule, "prox": prox_kind,
               "max_abs_err": float((out - plain).abs().max()),
               "ms": graph_ms(kern), "single_launches_ms": graph_ms(singles),
               "plain_ms": graph_ms(lambda: ref.fused_step_cells_math(
                   w, streams, alpha, lam, rule=rule, prox_kind=prox_kind)),
               "library_ms": graph_ms(lambda: torch.bmm(w, q)),
               "bound_ms": bound_ms, "bound_by": bound_by}
        row["share_of_bound"] = bound_ms / row["ms"]
        rows[(cells, m, d)] = row
        print("cells_kernel_case " + json.dumps(row), flush=True)
    return {"cases": cases, "rows": rows}


# ---------------------------------------------------------------------------
# phase 15: the paper's figures as batched sweeps at full scale
# ---------------------------------------------------------------------------

FIG_SCALE = 1.0
FIG1_SEEDS = 4
# batched vs sequential, fused vs plain: the tolerances of the reference's
# batched-vs-sequential tests (tests/test_runner_sweep.py): the same float32
# arithmetic in other orders (a vmapped product over the cells, a library
# sum order); the consensus distance, a norm of differences of nearly equal
# iterates, loses digits to cancellation
SWEEP_OBJ_TOL = dict(rtol=1e-4, atol=1e-6)
SWEEP_CONS_TOL = dict(rtol=1e-3, atol=1e-6)
# int8-quantized runs, batched against sequential: the vmapped products
# round the last ulp otherwise, and once such a difference puts a value on
# the other side of an int8 rounding boundary the runs differ by whole
# quantization steps (2.6e-4 relative in the objective over 120 steps on
# an H100 80GB HBM3; 1.4e-4 between the packages on the CPU).  This bound
# on the drift cannot tell an int8 row from an f32 one: with error
# feedback their objectives differ by less (the script prints that gap).
# What does is BEYOND_EARLY_STEPS below.
INT8_OBJ_RTOL = 1e-3
# the beyond matrix again over its first steps, where no int8 code has
# flipped yet: every row's objective and every cell's iterates batched
# against sequential at SWEEP_OBJ_TOL, and each int8 program's iterates
# must lie outside that tolerance of its f32 twin's (the upper reading: f32
# payloads in an int8 row's place would pass the objective checks)
BEYOND_EARLY_STEPS = 12


# F(x*)'s proximal gradient (benchmarks/pt_common.f_star, 4000 steps a
# figure dataset) replays one step from a CUDA graph on the card; its first
# F_STAR_CHECK_STEPS are held bit for bit to the eager loop on Fig. 5's data
F_STAR_CHECK_STEPS = 100


def check_f_star_replay(device, scale: float) -> dict:
    """``dpsvrg.centralized_prox_gd`` on Fig. 5's problem (mnist_like at
    ``scale``) replayed from its CUDA graph and run eagerly
    (``runner.CUDA_GRAPHS`` off): the iterates and the objective histories
    must be equal.  Returns the seconds of each."""
    from repro_torch.core import dpsvrg
    _, flat, h, _, d = pt_common.setup_problem("mnist_like", scale,
                                               device=device)
    out, secs = [], []
    for graphed in (True, False):
        runner.CUDA_GRAPHS = graphed
        try:
            _sync(device)
            t0 = time.perf_counter()
            out.append(dpsvrg.centralized_prox_gd(
                pt_common.logreg_loss, h, torch.zeros(d, device=device),
                flat, 0.4, F_STAR_CHECK_STEPS))
            _sync(device)
            secs.append(time.perf_counter() - t0)
        finally:
            runner.CUDA_GRAPHS = True
    (x, hist), (x_eager, hist_eager) = out
    if not (torch.equal(x, x_eager) and np.array_equal(hist, hist_eager)):
        fail(f"F(x*)'s proximal gradient replayed from a CUDA graph differs "
             f"from the eager loop: objectives {hist[:3]} vs "
             f"{hist_eager[:3]}, iterates by "
             f"{float((x - x_eager).abs().max())}")
    row = {"steps": F_STAR_CHECK_STEPS, "replayed_s": secs[0],
           "eager_s": secs[1], "objective_last": float(hist[-1])}
    print("f_star_replay " + json.dumps(row), flush=True)
    return row


def figure_sweeps(device, scale: float) -> list:
    """[(figure, method, Sweep, F(x*) or None)]: the paper's figure grids as
    the port's figure drivers define them, Fig. 4 (three lambdas), Fig. 5
    (four connectivities, one schedule a cell) and Fig. 1 (four seeds on
    each Table I dataset), each DPSVRG then DSPG."""
    from benchmarks import (pt_fig1_convergence, pt_fig4_lambda,
                            pt_fig5_connectivity)
    out = []
    for method, sw in pt_fig4_lambda.sweeps(scale, device).items():
        out.append(("fig4", method, sw, None))
    exps, fs = pt_fig5_connectivity.sweeps(scale, device)
    for method, sw in exps.items():
        out.append(("fig5", method, sw, fs))
    for dataset in pt_fig1_convergence.DATASETS:
        exps, fs = pt_fig1_convergence.sweeps(dataset, scale, device,
                                              seeds=FIG1_SEEDS)
        for method, sw in exps.items():
            out.append((f"fig1/{dataset}", method, sw, fs))
    return out


def _sweeps_agree(name: str, want, got) -> float:
    """Assert two sweeps' histories agree (counting columns exact); returns
    the objective's max abs difference."""
    for field in ("steps", "epochs", "comm_rounds"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field),
                                      err_msg=f"{name} {field}")
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  want.extras["wire_bytes"],
                                  err_msg=f"{name} wire_bytes")
    np.testing.assert_allclose(got.history.objective, want.history.objective,
                               **SWEEP_OBJ_TOL, err_msg=f"{name} objective")
    np.testing.assert_allclose(got.history.consensus, want.history.consensus,
                               **SWEEP_CONS_TOL, err_msg=f"{name} consensus")
    return float(np.max(np.abs(got.history.objective
                               - want.history.objective)))


def _over_tolerance(got, want, tol: dict) -> float:
    """max |got - want| / (atol + rtol |want|): above 1 exactly where
    ``np.testing.assert_allclose(got, want, **tol)`` fails."""
    return float(np.max(np.abs(got - want)
                        / (tol["atol"] + tol["rtol"] * np.abs(want))))


def _timed_sweep(sw, device, **kw):
    """(result, seconds, peak device memory in GB above what was allocated
    before; 0 on the CPU)."""
    base = 0
    if device != "cpu":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sw.run(device=device, **kw)
    peak = 0.0
    if device != "cpu":
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return res, time.perf_counter() - t0, peak


def paper_figures_phase(device="cuda", scale: float = FIG_SCALE) -> dict:
    """The figures' grids as batched fused sweeps on ``device`` (every
    launch count set to 0 before, read after: the cell-batched fused_step
    must launch once per inner step of each sweep, not once per cell),
    each held to its sequential resident runs and to the batched plain
    step, one Fig. 4 cell held to the CPU's host loop; ms per cell-step
    batched and sequential, the figures' derived columns and whether the
    paper's orderings hold.  Returns the launch counts and rows."""
    from benchmarks import (pt_fig1_convergence, pt_fig4_lambda,
                            pt_fig5_connectivity)
    t_setup = time.perf_counter()
    f_star_check = check_f_star_replay(device, scale)
    exps = figure_sweeps(device, scale)
    setup_s = time.perf_counter() - t_setup

    # the main path of this phase: every grid batched through the kernel
    _reset_launches()
    batched = {}
    for fig, method, sw, _ in exps:
        before = ops.launches_cells
        res, secs, peak = _timed_sweep(sw, device, sweep_batched=True,
                                       kernel="fused")
        batched[(fig, method)] = (res, secs, ops.launches_cells - before,
                                  peak)
    counts = _launch_counts()

    results, total_steps = [], 0
    for fig, method, sw, _ in exps:
        res, secs, launches, peak = batched[(fig, method)]
        name = f"{fig}/{method}"
        cells = res.history.objective.shape[1]
        steps = int(res.history.steps[-1, 0])
        total_steps += steps
        algo0, problem0 = sw.build(**{k: v[0] for k, v in sw.grid.items()
                                      if k not in ("seed", "schedule")})
        meta = algo0.meta
        if device != "cpu":
            if launches != steps:
                fail(f"{name}: {launches} cell-batched fused_step launches "
                     f"for {steps} steps of {cells} cells")
            check_graphs(name, res.extras, max_graphs(meta, sw.record_every))
        ledger = (res.extras["transfers_h2d"], res.extras["transfers_d2h"])
        if ledger != (1, 1):
            fail(f"{name}: transfer ledger {ledger}, want (1, 1)")
        for col in ("objective", "consensus"):
            if not np.all(np.isfinite(getattr(res.history, col))):
                fail(f"{name}: non-finite {col}")
        # timed in turns: batched (the counted run above), sequential,
        # sequential, batched, so that a drift weighs on both alike
        seq, seq_s, seq_peak = _timed_sweep(sw, device, resident=True,
                                            kernel="fused")
        _, seq_s2, _ = _timed_sweep(sw, device, resident=True,
                                    kernel="fused")
        again, secs2, _ = _timed_sweep(sw, device, sweep_batched=True,
                                       kernel="fused")
        plain, plain_s, _ = _timed_sweep(sw, device, sweep_batched=True,
                                         kernel="plain")
        data_gb = sum(leaf.numel() * leaf.element_size() for leaf in
                      pytree.tree_leaves(problem0.full_data)) / 1e9
        bat_s, sq_s = (secs + secs2) / 2, (seq_s + seq_s2) / 2
        row = {"sweep": name, "cells": cells, "steps": steps,
               "launches": launches,
               "max_abs_objective_vs_sequential": _sweeps_agree(
                   f"{name} batched vs sequential", seq, res),
               "max_abs_objective_vs_plain": _sweeps_agree(
                   f"{name} fused vs plain", plain, res),
               "max_abs_objective_rerun": _sweeps_agree(
                   f"{name} batched rerun", again, res),
               "batched_s": [secs, secs2], "sequential_s": [seq_s, seq_s2],
               "batched_plain_s": plain_s,
               "batched_ms_per_cell_step": bat_s / (steps * cells) * 1e3,
               "sequential_ms_per_cell_step": sq_s / (steps * cells) * 1e3,
               "batched_plain_ms_per_cell_step":
                   plain_s / (steps * cells) * 1e3,
               "batched_speedup": sq_s / bat_s,
               "dataset_gb": data_gb, "batched_peak_gb": peak,
               "sequential_peak_gb": seq_peak,
               "graphs_built": res.extras["graphs_built"],
               "max_graphs": max_graphs(meta, sw.record_every),
               "replays": res.extras["replays"],
               "capture_s": res.extras["capture_s"],
               "transfers": list(ledger)}
        results.append(row)
        print("figure_sweep " + json.dumps(row), flush=True)
    if device != "cpu" and counts["fused_step_cells"] != total_steps:
        fail(f"figures: {counts['fused_step_cells']} cell-batched launches "
             f"for {total_steps} inner steps")

    # one Fig. 4 cell (lambda = 0.01) against the CPU's host loop
    cpu_exps = pt_fig4_lambda.sweeps(scale, "cpu")
    for method, sw in cpu_exps.items():
        t0 = time.perf_counter()
        algo, problem = sw.build(lam=pt_fig4_lambda.LAMBDAS[1])
        host = runner.run(algo, problem, sw.sched, ExecSpec(
            gossip="dense", device="cpu"), seed=0,
            record_every=sw.record_every)
        card = batched[("fig4", method)][0].cell(1)
        np.testing.assert_array_equal(card.history.steps, host.history.steps)
        np.testing.assert_allclose(card.history.objective,
                                   host.history.objective, **SWEEP_OBJ_TOL,
                                   err_msg=f"fig4 {method}: card vs CPU")
        print("fig4_cell_vs_cpu " + json.dumps({
            "method": method, "lam": pt_fig4_lambda.LAMBDAS[1],
            "max_abs_objective": float(np.max(np.abs(
                card.history.objective - host.history.objective))),
            "cpu_host_loop_s": time.perf_counter() - t0}), flush=True)

    # the figures' derived columns, and the paper's orderings at this scale
    def res_of(fig, method):
        return batched[(fig, method)][0]

    rows = pt_fig4_lambda.rows(res_of("fig4", "dpsvrg"),
                               res_of("fig4", "dspg"))
    fs5 = next(fs for fig, _, _, fs in exps if fig == "fig5")
    rows += pt_fig5_connectivity.rows(res_of("fig5", "dpsvrg"),
                                      res_of("fig5", "dspg"), fs5)
    for dataset in pt_fig1_convergence.DATASETS:
        fig = f"fig1/{dataset}"
        fs = next(f for g, _, _, f in exps if g == fig)
        steps = [r for r in results if r["sweep"].startswith(fig)]
        rows += pt_fig1_convergence.rows(
            dataset, res_of(fig, "dpsvrg"), res_of(fig, "dspg"), fs,
            steps[0]["batched_ms_per_cell_step"] * 1e3,
            steps[1]["batched_ms_per_cell_step"] * 1e3)
    for r in rows:
        print(f"figure_row {r.name},{r.us_per_call:.1f},{r.derived}",
              flush=True)
    by = {r.name: r.data for r in rows}
    orderings = {
        "fig1_dpsvrg_gap_below_dspg": {
            ds: by[f"fig1/{ds}/dpsvrg"]["gap"] < by[f"fig1/{ds}/dspg"]["gap"]
            for ds in pt_fig1_convergence.DATASETS},
        "fig4_dpsvrg_loss_below_dspg": {
            str(lam): by[f"fig4/lambda={lam}"]["loss_dpsvrg"]
            < by[f"fig4/lambda={lam}"]["loss_dspg"]
            for lam in pt_fig4_lambda.LAMBDAS},
        "fig5_dpsvrg_gap_below_dspg": {
            str(b): by[f"fig5/b={b}"]["gap_dpsvrg"]
            < by[f"fig5/b={b}"]["gap_dspg"]
            for b in pt_fig5_connectivity.BS},
    }
    print("paper_orderings " + json.dumps(orderings), flush=True)
    if device != "cpu":
        fig5 = next(sw for fig, method, sw, _ in exps
                    if (fig, method) == ("fig5", "dpsvrg"))
        print("profile_figure_sweep " + json.dumps(
            profile_sweep(fig5, "fig5/dpsvrg")), flush=True)
    return {"launches": counts, "sweeps": results, "setup_s": setup_s,
            "orderings": orderings, "f_star_replay": f_star_check}


def profile_sweep(sw, name: str) -> dict:
    """Where the card's time goes in a batched sweep: the sweep traced by
    ``torch.profiler`` after a warm run, with the sweep driver's own host
    spans (plan, staging, issuing the pieces, the pull)."""
    from torch.profiler import ProfilerActivity, profile

    sw.run(device="cuda", sweep_batched=True, kernel="fused")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sw.run(device="cuda", sweep_batched=True, kernel="fused")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = {"sweep": name, "cells": res.history.objective.shape[1],
           "steps": int(res.history.steps[-1, 0]),
           "graphs_built": res.extras["graphs_built"],
           "replays": res.extras["replays"],
           "capture_s": res.extras["capture_s"]}
    out.update(device_busy(prof, wall_us))
    spans = {}
    for e in prof.events():
        if (e.name.startswith("sweep.")
                and e.device_type == torch.autograd.DeviceType.CPU):
            spans[e.name] = spans.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    out["host_spans_ms"] = spans
    return out


# ---------------------------------------------------------------------------
# phase 16: train h2o-danube-1.8b at full width, resume, serve the consensus
# ---------------------------------------------------------------------------

# h2o-danube-1.8b at full width (d_model 2560, 32 / 8 heads, d_ff 6912,
# vocab 32000, window 4096), float32, depth cut from 24 to 1 layer: 4
# layers (360 M parameters a node) fit the card, 1 keeps the whole script
# within its time limit since phases 25-26 came
TRAIN_LAYERS = 1
TRAIN_NODES = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_TOKENS = 2_000_000
TRAIN_LAM = 1e-6
TRAIN_TC = dict(num_steps=20, snapshot_every=10, snapshot_batch_mult=4,
                alpha=0.02, consensus_rounds=2, log_every=5, seed=0)
TRAIN_CKPT_EVERY = 10
TRAIN_PROMPTS = [256, 512, 768, 1024]
TRAIN_NEW = 16
TRAIN_MAX_LEN = 1088
# host loop vs resident path on the card: the same float32 work in the same
# order, so equal in practice; the tolerance of the CPU parity tests
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)


def _timed(fn, log: list):
    """``fn`` that appends each call's seconds to ``log``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log.append(time.perf_counter() - t0)
        return out
    return wrapper


def _free_card() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _train_run(cfg, tokens, device, algorithm: str, resident: bool,
               ckpt_dir=None, resume=False):
    """One train_loop run on the card; returns (history, seconds, peak
    bytes)."""
    sched = graphs.b_connected_ring_schedule(TRAIN_NODES, b=2, seed=0)
    ld = LMLoader(tokens, num_nodes=TRAIN_NODES, per_node_batch=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, seed=0)
    tc = trainer.TrainerConfig(
        algorithm=algorithm, ckpt_dir=ckpt_dir,
        ckpt_every=TRAIN_CKPT_EVERY if ckpt_dir else 0, **TRAIN_TC)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.train_loop(cfg, prox.l1(TRAIN_LAM), sched, ld, tc,
                              exec=ExecSpec(resident=resident,
                                            device=device),
                              resume=resume)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not np.all(np.isfinite(hist["loss"])):
        fail(f"train {algorithm}: losses {hist['loss']} are not finite")
    return hist, secs, torch.cuda.max_memory_allocated()


def _steady_ms(hist) -> float:
    """ms a step over steps 11-15: between the records at 10 and 15, where
    no snapshot refresh and no checkpoint falls."""
    t = dict(zip(hist["step"], hist["time"]))
    return (t[15] - t[10]) / 5 * 1e3


def train_phase(card: str, device="cuda", cfg=None) -> dict:
    """Phase 16.  Returns the numbers of the phase, launches among them.
    To rehearse it on the CPU: ``device="cpu"`` and a small ``cfg`` (a
    smoke variant), with ``torch.cuda``'s timers and counters patched out
    (launch counts stay 0 off the card)."""
    if cfg is None:
        cfg = configs.get_config("h2o-danube-1.8b").scaled(
            num_layers=TRAIN_LAYERS)
    ckpt_saves, ckpt_restores = [], []
    save, restore = checkpoint.save, checkpoint.restore
    checkpoint.save = _timed(save, ckpt_saves)
    checkpoint.restore = _timed(restore, ckpt_restores)
    work = os.path.join(ROOT, "build", "phase16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    _free_card()
    print(f"train: disk free under build/: "
          f"{shutil.disk_usage(work).free / 1e9:.1f} GB; card memory held "
          f"before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"(reserved {torch.cuda.memory_reserved() / 1e9:.2f} GB)",
          flush=True)
    try:
        result = _train_phase(cfg, card, device, work, ckpt_saves,
                              ckpt_restores)
    finally:
        checkpoint.save, checkpoint.restore = save, restore
        shutil.rmtree(work, ignore_errors=True)
    return result


def _train_phase(cfg, card, device, work, ckpt_saves, ckpt_restores) -> dict:
    tokens = synthetic.make_token_stream(TRAIN_TOKENS, cfg.vocab_size,
                                         seed=0).tokens
    n_params = transformer.param_count(
        transformer.init_params(cfg, 0, device=device))
    _free_card()
    tokens_per_eval = TRAIN_NODES * TRAIN_BATCH * TRAIN_SEQ
    flop_per_eval = 6 * n_params * tokens_per_eval
    result = {"card": card, "layers": cfg.num_layers, "params_per_node":
              n_params, "nodes": TRAIN_NODES,
              "tokens_per_gradient_eval": tokens_per_eval,
              "tflop_per_gradient_eval": flop_per_eval / 1e12,
              "ln_vocab": math.log(cfg.vocab_size)}

    def summary(name, hist, secs, peak, evals_per_step):
        ms = _steady_ms(hist)
        row = {"steps": hist["step"], "loss": hist["loss"],
               "loss_first": hist["loss"][0], "loss_last": hist["loss"][-1],
               "loss_fell": hist["loss"][-1] < hist["loss"][0],
               "run_s": secs,
               "ms_per_step_run": secs / TRAIN_TC["num_steps"] * 1e3,
               "ms_per_step_steady": ms,
               "tflops_steady": evals_per_step * flop_per_eval
               / (ms / 1e3) / 1e12,
               "max_memory_allocated_bytes": peak,
               "transfers": hist["transfers"]}
        result[name] = row
        print(f"train_{name} {card}: {ms:.1f} ms a step "
              f"({row['tflops_steady']:.1f} TFLOP/s of float32's 67), "
              f"peak {peak / 1e9:.1f} GB, loss {row['loss_first']:.4f} "
              f"(ln 32000 = {result['ln_vocab']:.4f}) -> "
              f"{row['loss_last']:.4f} (fell: {row['loss_fell']})",
              flush=True)

    # 1. DPSVRG on the host loop, then on the resident path (checkpointing
    # at steps 10 and 20): the histories agree, the ledger is exact
    host, secs, peak = _train_run(cfg, tokens, device, "dpsvrg", False)
    summary("dpsvrg_host", host, secs, peak, 2)
    if host["transfers"] != {"h2d": 20, "d2h": 5}:
        fail(f"train host: transfers {host['transfers']}")
    host_loss = host["loss"]
    del host
    _free_card()
    full_dir = os.path.join(work, "full")
    res, secs, peak = _train_run(cfg, tokens, device, "dpsvrg", True,
                                 ckpt_dir=full_dir)
    summary("dpsvrg_resident", res, secs, peak, 2)
    np.testing.assert_allclose(res["loss"], host_loss, **TRAIN_LOSS_TOL,
                               err_msg="train: resident vs host loop")
    result["max_abs_loss_resident_vs_host"] = float(np.max(np.abs(
        np.asarray(res["loss"]) - np.asarray(host_loss))))
    if res["transfers"] != {"h2d": 1, "d2h": 5 + 2}:
        fail(f"train resident: transfers {res['transfers']}")
    result["checkpoint_save_s"] = list(ckpt_saves)
    full_records = dict(zip(res["step"], res["loss"]))
    full_state = [(k, v.cpu()) for k, v in
                  checkpoint.flatten_with_paths(res["final_state"])]
    del res
    _free_card()

    # 2. resume from the step-10 checkpoint: bitwise the uninterrupted run
    shutil.rmtree(os.path.join(full_dir, "step_00000020"))
    resumed, secs, peak = _train_run(cfg, tokens, device, "dpsvrg", True,
                                     ckpt_dir=full_dir, resume=True)
    result["checkpoint_restore_s"] = list(ckpt_restores)
    if resumed["step"] != [10, 15, 19] or \
            [full_records[s] for s in resumed["step"]] != resumed["loss"]:
        fail(f"train resume: records {resumed['step']} "
             f"{resumed['loss']} differ from the uninterrupted run's")
    got = checkpoint.flatten_with_paths(resumed["final_state"])
    for (k, want), (k2, leaf) in zip(full_state, got):
        if k != k2 or not torch.equal(leaf.cpu(), want):
            fail(f"train resume: state leaf {k} differs from the "
                 f"uninterrupted run's")
    result["resume_bitwise"] = True
    result["resumed_run_s"] = secs
    del resumed, full_state, got
    _free_card()

    # 3. DSPG, resident, then on the host loop
    dspg, secs, peak = _train_run(cfg, tokens, device, "dspg", True)
    summary("dspg_resident", dspg, secs, peak, 1)
    if dspg["transfers"] != {"h2d": 1, "d2h": 5}:
        fail(f"train dspg resident: transfers {dspg['transfers']}")
    dspg_loss = dspg["loss"]
    del dspg
    _free_card()
    dspg, secs, peak = _train_run(cfg, tokens, device, "dspg", False)
    summary("dspg_host", dspg, secs, peak, 1)
    np.testing.assert_allclose(dspg_loss, dspg["loss"], **TRAIN_LOSS_TOL,
                               err_msg="train dspg: resident vs host loop")
    if dspg["transfers"] != {"h2d": 20, "d2h": 5}:
        fail(f"train dspg host: transfers {dspg['transfers']}")
    del dspg
    _free_card()

    # the snapshot refresh alone, and one traced DPSVRG step
    bundle = steps.build_train_step(cfg, prox.l1(TRAIN_LAM), TRAIN_NODES,
                                    algorithm="dpsvrg")
    ld = LMLoader(tokens, num_nodes=TRAIN_NODES, per_node_batch=TRAIN_BATCH,
                  seq_len=TRAIN_SEQ, seed=0)
    big = {k: torch.from_numpy(v).to(device) for k, v in zip(
        ("tokens", "labels"), ld.gather(ld.sample_starts(
            TRAIN_BATCH * TRAIN_TC["snapshot_batch_mult"])))}
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in zip(("tokens", "labels"), ld.sample())}
    phi = torch.as_tensor(graphs.b_connected_ring_schedule(
        TRAIN_NODES, b=2, seed=0).consensus_rounds(0, 2),
        dtype=torch.float32, device=device)
    state = bundle.init_state(0, device)
    refresh_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = bundle.snapshot_step(state, big)
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
    result["snapshot_refresh_ms"] = refresh_ms[-1]
    result["snapshot_refresh_tflops"] = 4 * flop_per_eval / (
        refresh_ms[-1] / 1e3) / 1e12
    state, _ = bundle.train_step(state, batch, phi, 0.05)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = bundle.train_step(state, batch, phi, 0.05)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    result["profile_dpsvrg_step"] = device_busy(prof, wall_us)
    del state, bundle, big, batch, prof
    _free_card()

    # 4. the consensus of the final checkpoint, served through the RMSNorm
    # and flash kernels: counts set to 0 just before, read just after
    kcfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params, info = consensus.consensus_params(full_dir, kcfg, device=device)
    torch.cuda.synchronize()
    result["consensus_load_s"] = time.perf_counter() - t0
    result["consensus"] = {"step": info.step, "num_nodes": info.num_nodes,
                           "node_dist": list(info.node_dist),
                           "consensus_rel": info.consensus_rel}
    print(info, flush=True)
    if info.step != TRAIN_TC["num_steps"] or info.num_nodes != TRAIN_NODES:
        fail(f"consensus: {info}")
    reqs = _requests(cfg.vocab_size, TRAIN_PROMPTS, TRAIN_NEW, DANUBE_SEED)
    eng = TimedEngine(kcfg, params, max_slots=len(reqs),
                      max_len=TRAIN_MAX_LEN, chunk=DANUBE_CHUNK)
    for r in reqs:
        eng.submit(r)
    rn_ops.launches = 0
    fa_ops.launches = 0
    outs = eng.run_until_done()
    torch.cuda.synchronize()
    flash_n, rms_n = fa_ops.launches, rn_ops.launches
    chunks = eng.transfers["chunks"]
    want_flash = kcfg.num_layers * len(reqs)
    want_rms = (2 * kcfg.num_layers + 1) * (len(reqs) + chunks * DANUBE_CHUNK)
    if (flash_n, rms_n) != (want_flash, want_rms):
        fail(f"consensus serve: launches flash {flash_n} rmsnorm {rms_n}, "
             f"want {want_flash} and {want_rms}")
    if eng.transfers != {"h2d": len(reqs), "d2h": chunks, "chunks": chunks}:
        fail(f"consensus serve: transfers {eng.transfers}")
    if any(len(outs[r.uid]) != TRAIN_NEW for r in reqs):
        fail("consensus serve: a request did not get its tokens")
    result["serve"] = {"launches": {"flash_attention": flash_n,
                                    "rmsnorm": rms_n},
                       "transfers": dict(eng.transfers),
                       "engine_prefill_ms": {str(k): v for k, v in
                                             sorted(eng.prefill_ms.items())},
                       "chunk_ms": statistics.median(eng.chunk_ms),
                       "decode_step_ms": statistics.median(eng.chunk_ms)
                       / DANUBE_CHUNK}
    del eng
    result["serve"].update(_check_served(
        kcfg, params, reqs, outs, slots=len(reqs), max_len=TRAIN_MAX_LEN,
        device=device))
    del params
    _free_card()

    # 5. the launchers at their smoke size, as a user runs them
    launch_dir = os.path.join(work, "launch")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for argv in (["repro_torch.launch.train", "--steps", "10",
                  "--ckpt-dir", launch_dir],
                 ["repro_torch.launch.serve", "--ckpt-dir", launch_dir]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m"] + argv
                              + ["--device", str(device)], env=env,
                              capture_output=True, text=True, cwd=ROOT)
        print(f"{argv[0]}: rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{proc.stdout.strip().splitlines()[-1:]}", flush=True)
        if proc.returncode != 0:
            fail(f"{argv[0]} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
    print("train_consensus " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 17: network-event scenarios (link failures, churn, stale gossip,
# stragglers) through the batched sweeps, and the beyond_noniid matrix
# ---------------------------------------------------------------------------

SCEN_SCALE = 1.0
SCEN_SEEDS = [0, 1]
# the schedule axis of the scenario_kernel sweep: schedule-level models
# only, so the wire stays stateless and fused_step takes every step
SCEN_FAILURES = {
    "none": [],
    "links30": [scenarios.LinkFailures(0.3)],
    "churn20": [scenarios.NodeChurn(0.2, dwell=5)],
    "both": [scenarios.LinkFailures(0.3), scenarios.NodeChurn(0.2, dwell=5)],
}
SCEN_STALE = [scenarios.StaleGossip(3), scenarios.Stragglers(2.0)]
SCEN_STALE_STEPS = 120
SCEN_STALE_RECORD = 30
# the scenario_kernel sweep's moving twin: at the main path's l1 0.01 the
# iterate keeps 16 of 8,192 coordinates and every cell ends at the same
# float32 numbers whatever its failures, so a W staged for the wrong cell
# would not show; at 1e-4 the cells' iterates move apart (their objectives
# hardly do: a doubly stochastic W keeps the nodes' average, and F is taken
# there), so the twin holds the iterates and the consensus distance
SCEN_MOVING_LAM = 1e-4
# the stale runs' l1 weight: under delay 3 on the ring a node's own term
# is a third of its step, which at l1 0.01 stays under the threshold, so
# GT-SVRG's iterate never leaves 0 and a check would compare zeros; at
# 1e-4 both methods move (phase 8's moving twin does the same)
SCEN_STALE_LAM = 1e-4
# fused_step over the scenario sweep's cells: (cells, m, d), one realized
# degraded W a cell a step
SCEN_KERNEL_SHAPE = (8, 8, 1024)


def _scenario_problem(parts, dim: int, device, lam=None):
    """The main path's problem on ``device``; ``lam`` replaces its l1
    weight."""
    cfg = paper_logreg.CONFIG
    data = params_from_numpy(parts, device)
    x0 = gossip.stack_tree(torch.zeros(dim, device=device),
                           cfg.num_nodes).contiguous()
    return algorithm.Problem(logreg_loss, prox.l1(cfg.lam if lam is None
                                                  else lam), x0, data)


def scenario_schedules():
    """(base ring, {failure: schedule}, the shared ScenarioBackend): each
    failure's models composed over the paper's b=1 ring by
    ``scenarios.apply`` (scenario seed 0); "none" is the ring itself."""
    base = graphs.b_connected_ring_schedule(paper_logreg.CONFIG.num_nodes, 1)
    scheds, backends = {}, set()
    for name, models in SCEN_FAILURES.items():
        sched, backend = scenarios.apply(base, models, seed=0)
        scheds[name] = sched
        if models:
            backends.add(backend)
    if len(backends) != 1:
        fail(f"scenario_kernel: the failures resolve to {len(backends)} "
             f"transports, want one")
    return base, scheds, backends.pop()


def _scenario_dpsvrg(problem):
    """DPSVRG with the main path's hyper-parameters (30 rounds)."""
    cfg = paper_logreg.CONFIG
    return algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
        alpha=cfg.alpha, beta=cfg.beta, n0=cfg.n0, num_outer=30))


def _scenario_kernel_sweep(problem, schedules, backend, device, kernel,
                           batched=True):
    """DPSVRG over the (schedule x seed) grid (``schedules`` a dict), or
    over the seeds on one schedule, one record an outer round."""
    def build():
        return _scenario_dpsvrg(problem), problem

    grid = {"seed": SCEN_SEEDS}
    if isinstance(schedules, dict):
        grid = {"schedule": list(schedules.values()), "seed": SCEN_SEEDS}
        schedules = None
    return sweep.run_sweep(build, grid, schedules, ExecSpec(
        resident=True, kernel=kernel, gossip=backend, device=device),
        record_every=0, batched=batched)


def _stale_algo(problem, name: str):
    """Loopless DPSVRG or GT-SVRG (4 rounds) over SCEN_STALE_STEPS steps,
    at the step sizes of the beyond_noniid matrix (0.2 and 0.1: at the main
    path's 0.01 GT-SVRG's iterate stays at 0 under the l1 prox, and a check
    would compare zeros)."""
    if name == "gt_svrg":
        return algorithm.gt_svrg_algorithm(problem, 0.1, 4,
                                           SCEN_STALE_STEPS // 4)
    return algorithm.loopless_dpsvrg_algorithm(
        problem, 0.2, SCEN_STALE_STEPS, snapshot_prob=0.1)


def _stale_sweep(problem, name: str, device):
    """``_stale_algo`` under StaleGossip(3) + Stragglers(2.0) over the b=1
    ring, both seeds batched, through the plain step (the threaded mix
    state keeps the fused step out)."""
    base = graphs.b_connected_ring_schedule(paper_logreg.CONFIG.num_nodes, 1)
    sched, backend = scenarios.apply(base, SCEN_STALE, seed=0)

    def build():
        return _stale_algo(problem, name), problem

    return sweep.run_sweep(build, {"seed": SCEN_SEEDS}, sched, ExecSpec(
        resident=True, kernel="plain", gossip=backend, device=device),
        record_every=SCEN_STALE_RECORD)


def scenario_kernel_case(schedules) -> dict:
    """fused_step over the scenario sweep's cells at SCEN_KERNEL_SHAPE,
    svrg l1: each of 20 captured calls takes the next step's stack of
    realized degraded matrices (one a cell), as the sweep stages them.
    Held to the plain version and bitwise to single launches; timed beside
    its bound, the single launches, the plain version and ``bmm(W, q)``."""
    cells, m, d = SCEN_KERNEL_SHAPE
    rule, prox_kind, iters = "svrg", "l1", 20
    per_cell = [s for s in schedules.values() for _ in SCEN_SEEDS]
    ws = [torch.as_tensor(np.stack([s.matrix(1 + t) for s in per_cell]),
                          dtype=torch.float32, device="cuda")
          for t in range(iters)]
    rng = np.random.default_rng(d)
    streams = [torch.as_tensor(rng.normal(size=(cells, m, d)),
                               dtype=torch.float32, device="cuda")
               for _ in range(4)]
    alpha = torch.full((cells,), 0.05, device="cuda")
    lam = 0.01
    err = 0.0
    for w in ws:
        out = ops.fused_step_cells_buf(w, streams, alpha, lam, rule=rule,
                                       prox_kind=prox_kind)
        plain = ref.fused_step_cells_math(w, streams, alpha, lam, rule=rule,
                                          prox_kind=prox_kind)
        torch.testing.assert_close(out, plain, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        if not torch.equal(out, torch.stack(single_launches(
                w, streams, alpha, lam, rule, prox_kind))):
            fail("fused_step over degraded cells differs from single "
                 "launches")
        err = max(err, float((out - plain).abs().max()))
    q = streams[0] - alpha[:, None, None] * streams[1]

    def cycling(fn):
        state = {"t": 0}

        def call():
            w = ws[state["t"] % iters]
            state["t"] += 1
            return fn(w)
        return call

    def singles(w):
        for c in range(cells):
            ops.fused_step_buf(w[c], [s[c] for s in streams], alpha[c], lam,
                               rule=rule, prox_kind=prox_kind)

    bound_ms, bound_by = cells_bound(cells, m, d, rule, prox_kind, cells)
    row = {"shape": [cells, m, d], "rule": rule, "prox": prox_kind,
           "w": "per step, per cell (realized degraded)",
           "max_abs_err": err,
           "ms": graph_ms(cycling(lambda w: ops.fused_step_cells_buf(
               w, streams, alpha, lam, rule=rule, prox_kind=prox_kind)),
               iters),
           "single_launches_ms": graph_ms(cycling(singles), iters),
           "plain_ms": graph_ms(cycling(lambda w: ref.fused_step_cells_math(
               w, streams, alpha, lam, rule=rule, prox_kind=prox_kind)),
               iters),
           "library_ms": graph_ms(cycling(lambda w: torch.bmm(w, q)), iters),
           "bound_ms": bound_ms, "bound_by": bound_by}
    row["share_of_bound"] = bound_ms / row["ms"]
    return row


def _beyond_int8_vs_f32(rows) -> dict:
    """min and max over the matrix's cells of |int8 - f32| / |f32| in the
    final objective, each int8 row against its f32 twin."""
    f32 = {(r.topology, r.failure, r.algorithm, r.seed): r.objective
           for r in rows if r.compression == "f32"}
    rel = [abs(r.objective - f32[(r.topology, r.failure, r.algorithm,
                                  r.seed)]) / abs(f32[(r.topology, r.failure,
                                                       r.algorithm, r.seed)])
           for r in rows if r.compression == "int8"]
    return {"min": min(rel), "max": max(rel)}


def _beyond_early(bproblem, device) -> dict:
    """The beyond matrix over BEYOND_EARLY_STEPS steps, batched against
    sequential: row objectives and cell iterates at SWEEP_OBJ_TOL, counts
    exact; each int8 program's iterates more than that tolerance from its
    f32 twin's."""
    from benchmarks import pt_beyond_noniid
    bat = pt_beyond_noniid.matrix(bproblem, device, steps=BEYOND_EARLY_STEPS)
    seq = pt_beyond_noniid.matrix(bproblem, device, batched=False,
                                  steps=BEYOND_EARLY_STEPS)
    for b, s in zip(bat.rows, seq.rows):
        if b[:5] != s[:5] or (b.wire_bytes, b.comm_rounds, b.steps) != \
                (s.wire_bytes, s.comm_rounds, s.steps):
            fail(f"beyond_noniid early {b[:5]}: labels or counts differ "
                 f"batched vs sequential")
        np.testing.assert_allclose(b.objective, s.objective, **SWEEP_OBJ_TOL,
                                   err_msg=f"beyond_noniid early {b[:5]}")
    params = {}
    max_abs = 0.0
    for gb, gs in zip(bat.groups, seq.groups):
        key = (gb["algorithm"], gb["compression"],
               tuple(gb["transport"].values()))
        xb = gb["sweep"].params.cpu().numpy()
        xs = gs["sweep"].params.cpu().numpy()
        np.testing.assert_allclose(xb, xs, **SWEEP_OBJ_TOL,
                                   err_msg=f"beyond_noniid early {key}: "
                                   f"iterates, batched vs sequential")
        max_abs = max(max_abs, float(np.max(np.abs(xb - xs))))
        params[key] = xb
    apart = [_over_tolerance(x, params[(a, "f32", t)], SWEEP_OBJ_TOL)
             for (a, c, t), x in params.items() if c == "int8"]
    if min(apart) <= 1.0:
        fail(f"beyond_noniid early: an int8 program's iterates lie within "
             f"the tolerance of its f32 twin's ({apart}), so the check "
             f"cannot see the quantization")
    return {"steps": BEYOND_EARLY_STEPS,
            "max_abs_params_batched_vs_sequential": max_abs,
            "max_rel_objective_batched_vs_sequential": max(
                abs(b.objective - s.objective) / abs(s.objective)
                for b, s in zip(bat.rows, seq.rows)),
            "int8_vs_f32_params_over_tolerance": apart}


def scenario_phase(device="cuda", scale: float = SCEN_SCALE) -> dict:
    """Phase 17.  (a) ``scenario_kernel``: DPSVRG on cifar10_like over the
    (failure x seed) grid through the cell-batched fused_step (every count
    set to 0 before, read after: one launch a step for all 8 cells), held
    to the plain step, to sequential resident runs and to the CPU; its
    zero-intensity cells bitwise an unwrapped batched sweep's.  (b)
    ``scenario_stale``: loopless DPSVRG and GT-SVRG under stale gossip and
    stragglers, graphs against eager against the CPU.  (c) the
    ``beyond_noniid`` matrix at ``scale``, batched against sequential.
    To rehearse it on the CPU: ``device="cpu"`` and a small ``scale``
    (launch counts and graphs are not checked off the card)."""
    from benchmarks import pt_beyond_noniid
    card = device != "cpu"
    t0 = time.perf_counter()
    ds = synthetic.make_paper_dataset("cifar10_like", scale=scale, seed=0)
    parts = synthetic.partition_per_node(ds, paper_logreg.CONFIG.num_nodes)
    problem = _scenario_problem(parts, ds.dim, device)
    base, schedules, backend = scenario_schedules()
    setup_s = time.perf_counter() - t0
    cells = len(schedules) * len(SCEN_SEEDS)

    # (a) the main path of this phase: the grid batched through the kernel
    _reset_launches()
    t0 = time.perf_counter()
    fused = _scenario_kernel_sweep(problem, schedules, backend, device,
                                   "fused")
    pt_common.sync(device)
    fused_s = time.perf_counter() - t0
    counts = _launch_counts()
    steps = int(fused.history.steps[-1, 0])
    meta = _scenario_dpsvrg(problem).meta
    if card:
        if counts["fused_step_cells"] != steps or counts["fused_step"] != 0:
            fail(f"scenario_kernel: {counts['fused_step_cells']} "
                 f"cell-batched fused_step launches (single: "
                 f"{counts['fused_step']}) for {steps} steps of {cells} "
                 f"cells")
        check_graphs("scenario_kernel", fused.extras, max_graphs(meta, 0))
    ledger = (fused.extras["transfers_h2d"], fused.extras["transfers_d2h"])
    if ledger != (1, 1):
        fail(f"scenario_kernel: transfer ledger {ledger}, want (1, 1)")
    if not np.all(np.isfinite(fused.history.objective)):
        fail("scenario_kernel: non-finite objective")
    nonzero = [int(c) for c in (fused.params != 0).reshape(cells, -1)
               .sum(dim=1).tolist()]
    if min(nonzero) == 0:
        fail(f"scenario_kernel: a cell's final iterate is all zeros "
             f"({nonzero})")

    t0 = time.perf_counter()
    before = ops.launches_cells
    plain = _scenario_kernel_sweep(problem, schedules, backend, device,
                                   "plain")
    pt_common.sync(device)
    plain_s = time.perf_counter() - t0
    if card and ops.launches_cells != before:
        fail("scenario_kernel: the plain step launched fused_step")
    # the sequential runs go through the single launch: counts set to 0
    # before, read after
    _reset_launches()
    t0 = time.perf_counter()
    seq = _scenario_kernel_sweep(problem, schedules, backend, device,
                                 "fused", batched=False)
    pt_common.sync(device)
    seq_s = time.perf_counter() - t0
    seq_counts = _launch_counts()
    if card and (seq_counts["fused_step"] != steps * cells
                 or seq_counts["fused_step_cells"] != 0):
        fail(f"scenario_kernel: sequential runs launched fused_step "
             f"{seq_counts['fused_step']} times (cell-batched: "
             f"{seq_counts['fused_step_cells']}) for {steps * cells} "
             f"cell-steps")
    t0 = time.perf_counter()
    cpu_problem = _scenario_problem(parts, ds.dim, "cpu")
    cpu = _scenario_kernel_sweep(cpu_problem, schedules, backend, "cpu",
                                 "fused")
    cpu_s = time.perf_counter() - t0
    unwrapped = _scenario_kernel_sweep(problem, base, "dense", device,
                                       "fused")
    zero = fused.history.objective[:, :len(SCEN_SEEDS)]
    if not np.array_equal(zero, unwrapped.history.objective):
        fail(f"scenario_kernel: zero-intensity cells differ from the "
             f"unwrapped sweep by "
             f"{np.max(np.abs(zero - unwrapped.history.objective))}")
    # the batched run again, warm (the first run of a process pays its
    # lazy set-up), in turns after the plain and sequential runs
    t0 = time.perf_counter()
    again = _scenario_kernel_sweep(problem, schedules, backend, device,
                                   "fused")
    pt_common.sync(device)
    warm_s = time.perf_counter() - t0
    if not np.array_equal(again.history.objective, fused.history.objective):
        fail("scenario_kernel: a rerun of the batched sweep differs")

    # the moving twin: batched through the kernel against the cells' own
    # sequential runs (each staged alone) and against the same sweep on the
    # CPU (no graphs, no static buffers: a fault in copying a step's W
    # into the card's graphs shows here), and the failures must show
    moving = _scenario_problem(parts, ds.dim, device, SCEN_MOVING_LAM)
    before = ops.launches_cells
    twin = _scenario_kernel_sweep(moving, schedules, backend, device,
                                  "fused")
    if card and ops.launches_cells - before != steps:
        fail("scenario_kernel moving twin: cell-batched launches")
    twin_seq = _scenario_kernel_sweep(moving, schedules, backend, device,
                                      "fused", batched=False)
    t0 = time.perf_counter()
    twin_cpu = _scenario_kernel_sweep(
        _scenario_problem(parts, ds.dim, "cpu", SCEN_MOVING_LAM), schedules,
        backend, "cpu", "fused")
    twin_cpu_s = time.perf_counter() - t0
    twin_x = twin.params.cpu().numpy()
    for name, other in (("sequential", twin_seq), ("CPU", twin_cpu)):
        np.testing.assert_allclose(
            twin_x, other.params.cpu().numpy(), **SWEEP_OBJ_TOL,
            err_msg=f"scenario_kernel moving twin: iterates, batched vs "
            f"{name}")
        np.testing.assert_allclose(
            twin.history.consensus, other.history.consensus,
            **SWEEP_CONS_TOL, err_msg=f"scenario_kernel moving twin: "
            f"consensus, batched vs {name}")
    # each failure cell against its seed's undegraded cell, in units of the
    # iterate tolerance: a W staged for the wrong cell would pass the
    # checks above only if this stayed under 1
    k = len(SCEN_SEEDS)
    apart = [_over_tolerance(twin_x[c], twin_x[c % k], SWEEP_OBJ_TOL)
             for c in range(k, cells)]
    if min(apart) <= 1.0:
        fail(f"scenario_kernel moving twin: a failure cell ended within "
             f"the iterate tolerance of the undegraded cell ({apart})")
    twin_nonzero = [int(n) for n in (twin.params != 0).reshape(cells, -1)
                    .sum(dim=1).tolist()]
    kernel_row = {
        "cells": cells, "steps": steps,
        "launches": counts["fused_step_cells"],
        "failures": list(SCEN_FAILURES), "seeds": SCEN_SEEDS,
        "max_abs_objective_vs_plain": _sweeps_agree(
            "scenario_kernel fused vs plain", plain, fused),
        "max_abs_objective_vs_sequential": _sweeps_agree(
            "scenario_kernel batched vs sequential", seq, fused),
        "max_abs_objective_vs_cpu": _sweeps_agree(
            "scenario_kernel card vs CPU", cpu, fused),
        "zero_intensity_bitwise": True,
        "objective_last": fused.history.objective[-1].tolist(),
        "wire_bytes_last": fused.extras["wire_bytes"][-1].tolist(),
        "nonzero_last": nonzero,
        "moving_lam": SCEN_MOVING_LAM,
        "moving_max_abs_objective_vs_sequential": _sweeps_agree(
            "scenario_kernel moving twin batched vs sequential", twin_seq,
            twin),
        "moving_objective_last": twin.history.objective[-1].tolist(),
        "moving_consensus_last": twin.history.consensus[-1].tolist(),
        "moving_max_abs_params_vs_sequential": float(
            (twin.params - twin_seq.params).abs().max()),
        "moving_max_abs_params_vs_cpu": float(
            np.max(np.abs(twin_x - twin_cpu.params.numpy()))),
        "moving_max_abs_objective_vs_cpu": _sweeps_agree(
            "scenario_kernel moving twin card vs CPU", twin_cpu, twin),
        "moving_failure_cells_over_tolerance": apart,
        "moving_cpu_s": twin_cpu_s,
        "moving_nonzero_last": twin_nonzero,
        "batched_s": [fused_s, warm_s], "plain_s": plain_s,
        "sequential_s": seq_s, "sequential_launches": seq_counts[
            "fused_step"], "cpu_s": cpu_s,
        "batched_ms_per_cell_step": warm_s / (steps * cells) * 1e3,
        "plain_ms_per_cell_step": plain_s / (steps * cells) * 1e3,
        "sequential_ms_per_cell_step": seq_s / (steps * cells) * 1e3,
        "graphs_built": fused.extras["graphs_built"],
        "max_graphs": max_graphs(meta, 0),
        "replays": fused.extras["replays"],
        "capture_s": fused.extras["capture_s"],
        "transfers": list(ledger)}
    print("scenario_kernel " + json.dumps(kernel_row), flush=True)
    case = scenario_kernel_case(schedules) if card else None
    if case is not None:
        print("scenario_kernel_case " + json.dumps(case), flush=True)

    # (b) stale gossip and stragglers: a threaded mix state in every cell
    stale_problem = _scenario_problem(parts, ds.dim, device, SCEN_STALE_LAM)
    stale_cpu_problem = _scenario_problem(parts, ds.dim, "cpu",
                                          SCEN_STALE_LAM)
    stale_rows = []
    for name in ("loopless_dpsvrg", "gt_svrg"):
        t0 = time.perf_counter()
        graph = _stale_sweep(stale_problem, name, device)
        pt_common.sync(device)
        graph_s = time.perf_counter() - t0
        runner.CUDA_GRAPHS = False
        try:
            eager = _stale_sweep(stale_problem, name, device)
        finally:
            runner.CUDA_GRAPHS = True
        stale_cpu = _stale_sweep(stale_cpu_problem, name, "cpu")
        if card:
            check_graphs(f"scenario_stale {name}", graph.extras,
                         max_graphs(_stale_algo(problem, name).meta,
                                    SCEN_STALE_RECORD))
            if eager.extras["replays"] != 0:
                fail(f"scenario_stale {name}: the eager executor replayed "
                     f"graphs")
        if (graph.extras["transfers_h2d"],
                graph.extras["transfers_d2h"]) != (1, 1):
            fail(f"scenario_stale {name}: transfer ledger")
        obj = graph.history.objective
        if not np.all(np.isfinite(obj)) or not np.all(obj[-1] < obj[0]):
            fail(f"scenario_stale {name}: the objective is not finite or "
                 f"did not fall ({obj[0]} -> {obj[-1]})")
        stale_nonzero = [int(n) for n in (graph.params != 0).reshape(
            len(SCEN_SEEDS), -1).sum(dim=1).tolist()]
        if min(stale_nonzero) == 0:
            fail(f"scenario_stale {name}: a cell's final iterate is all "
                 f"zeros")
        row = {"algorithm": name, "cells": len(SCEN_SEEDS),
               "steps": int(graph.history.steps[-1, 0]),
               "max_abs_graph_vs_eager": _sweeps_agree(
                   f"scenario_stale {name} graphs vs eager", eager, graph),
               "max_abs_objective_vs_cpu": _sweeps_agree(
                   f"scenario_stale {name} card vs CPU", stale_cpu, graph),
               "objective_first": graph.history.objective[0].tolist(),
               "objective_last": graph.history.objective[-1].tolist(),
               "nonzero_last": stale_nonzero, "lam": SCEN_STALE_LAM,
               "graph_s": graph_s,
               "graphs_built": graph.extras["graphs_built"],
               "replays": graph.extras["replays"]}
        stale_rows.append(row)
        print("scenario_stale " + json.dumps(row), flush=True)

    # (c) the beyond_noniid matrix at this scale: batched vs sequential
    t0 = time.perf_counter()
    bproblem, fs = pt_beyond_noniid.setup(scale, device)
    beyond_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bat = pt_beyond_noniid.matrix(bproblem, device)
    pt_common.sync(device)
    bat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bseq = pt_beyond_noniid.matrix(bproblem, device, batched=False)
    pt_common.sync(device)
    bseq_s = time.perf_counter() - t0
    if [r[:5] for r in bat.rows] != [r[:5] for r in bseq.rows]:
        fail("beyond_noniid: batched and sequential rows differ in labels")
    max_rel = {"f32": 0.0, "int8": 0.0}
    for b, s in zip(bat.rows, bseq.rows):
        if (b.wire_bytes, b.comm_rounds, b.steps) != \
                (s.wire_bytes, s.comm_rounds, s.steps):
            fail(f"beyond_noniid {b[:5]}: counts differ batched vs "
                 f"sequential")
        np.testing.assert_allclose(
            b.objective, s.objective, atol=SWEEP_OBJ_TOL["atol"],
            rtol=SWEEP_OBJ_TOL["rtol"] if b.compression == "f32"
            else INT8_OBJ_RTOL, err_msg=f"beyond_noniid {b[:5]}")
        max_rel[b.compression] = max(max_rel[b.compression],
                                     abs(b.objective - s.objective)
                                     / abs(s.objective))
    for grp in bat.groups:
        if (grp["transfers_h2d"], grp["transfers_d2h"]) != (1, 1):
            fail(f"beyond_noniid {grp['algorithm']} {grp['compression']} "
                 f"{grp['transport']}: ledger")
    int8_vs_f32 = _beyond_int8_vs_f32(bat.rows)
    early = _beyond_early(bproblem, device)
    cell_steps = sum(r.steps for r in bat.rows)
    front = scenarios.pareto_frontier(bat.rows)
    beyond_row = {
        "scale": scale,
        "n": int(np.prod(bproblem.full_data["labels"].shape)),
        "cells": len(bat.rows), "programs": len(bat.groups),
        "f_star": fs, "max_rel_objective_batched_vs_sequential": max_rel,
        "int8_rtol": INT8_OBJ_RTOL,
        "int8_vs_f32_rel_objective": int8_vs_f32, "early": early,
        "batched_s": bat_s, "sequential_s": bseq_s,
        "setup_s": beyond_setup_s,
        "batched_ms_per_cell_step": bat_s / cell_steps * 1e3,
        "sequential_ms_per_cell_step": bseq_s / cell_steps * 1e3,
        "frontier": [f"{r.algorithm}/{r.compression}/{r.topology}/"
                     f"{r.failure}@{r.wire_bytes}B obj={r.objective:.6f}"
                     for r in front[:4]]}
    print("beyond_noniid " + json.dumps(beyond_row), flush=True)
    for r in pt_beyond_noniid.rows(bat, fs):
        print(f"beyond_row {r.name},{r.us_per_call:.1f},{r.derived}",
              flush=True)
    out = {"launches": counts, "launches_sequential": seq_counts,
           "kernel": kernel_row, "case": case,
           "stale": stale_rows, "beyond": beyond_row, "setup_s": setup_s}
    print("scenarios " + json.dumps({
        "launches_fused_step_cells": counts["fused_step_cells"],
        "scenario_kernel_ms_per_cell_step": kernel_row[
            "batched_ms_per_cell_step"],
        "scenario_kernel_vs_cpu": kernel_row["max_abs_objective_vs_cpu"],
        "stale_graph_vs_eager": [r["max_abs_graph_vs_eager"]
                                 for r in stale_rows],
        "beyond_batched_ms_per_cell_step": beyond_row[
            "batched_ms_per_cell_step"],
        "beyond_sequential_ms_per_cell_step": beyond_row[
            "sequential_ms_per_cell_step"],
        "beyond_frontier": beyond_row["frontier"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the execution modes: device sampling on the main path, the scan
# path, device-sampled sweeps, train_sweep and device-sampled training
# ---------------------------------------------------------------------------

EXEC_SCAN_STEPS = 600
EXEC_SCAN_RECORD = 50
# train_sweep at full width: h2o-danube-1.8b cut from 24 to 1 layer (151 M
# parameters a node; 2 layers, 10.6 GB of state a cell, fit the card, 1
# keeps the whole script within its time limit since phases 25-26 came);
# each cell its own lambda and alpha
SWEEP_TRAIN_LAYERS = 1
SWEEP_TRAIN_GRID = {"lam": [1e-6, 1e-5], "alpha": [0.02, 0.01]}
SWEEP_TRAIN_MODE = "zip"
# 10 steps, snapshot refreshes at steps 0 and 5, a record every step; the
# device-sampled run is resumed from a checkpoint at step 5
SWEEP_TRAIN_TC = dict(num_steps=10, snapshot_every=5, snapshot_batch_mult=4,
                      alpha=0.02, consensus_rounds=2, log_every=1, seed=0)
DEVICE_TRAIN_CKPT_STEP = 5


def _sync(device) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _peak_reset(device) -> None:
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if device != "cpu" else 0


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _device_sampled_main_path(parts, dim, device) -> tuple:
    """(a) DPSVRG then DSPG on the main path with device sampling, through
    the kernel and CUDA graphs: fused_step once a step (counts set to 0
    before, read after), graphs bit for bit the eager executor's, the card
    held to the CPU, the run in the host-sampled run's envelope, the ledger
    (1, 1); ms a step beside host sampling, timed in turns in this process
    after those runs (host, device, device, host), and both runs' traced
    idle shares."""
    card = device != "cpu"
    # the stream itself: the card draws the CPU's indices, exactly (at the
    # main path's l1 weight the objective hardly depends on the draws)
    n = next(iter(parts.values())).shape[1]
    steps_t = torch.arange(1, 2000, dtype=torch.int64)
    for key in (0, 12345, 2**31 - 2):
        want = device_sampling.IndexStream(
            key, m=paper_logreg.CONFIG.num_nodes, bsz=1, n=n,
            device="cpu")(steps_t)
        got = device_sampling.IndexStream(
            key, m=paper_logreg.CONFIG.num_nodes, bsz=1, n=n,
            device=device)(steps_t.to(device))
        if not torch.equal(got.cpu(), want):
            fail(f"device sampling: the {device} stream's indices differ "
                 f"from the CPU's for key {key}")
    ops.launches = 0
    dev = main_path_runs(device, parts, dim, "fused", sampling="device")
    launches = ops.launches
    cpu = main_path_runs("cpu", parts, dim, "fused", sampling="device")
    runner.CUDA_GRAPHS = False
    eager = main_path_runs(device, parts, dim, "fused", sampling="device")
    runner.CUDA_GRAPHS = True
    host1 = main_path_runs(device, parts, dim, "fused")
    dev1 = main_path_runs(device, parts, dim, "fused", sampling="device")
    dev2 = main_path_runs(device, parts, dim, "fused", sampling="device")
    host2 = main_path_runs(device, parts, dim, "fused")
    rows = {}
    for i, (name, res, steps, n, secs, most) in enumerate(dev):
        cres, eres = cpu[i][1], eager[i][1]
        hres = host1[i][1]
        if card and (n != steps or eager[i][3] != steps):
            fail(f"device sampling {name}: {n} fused_step launches (eager "
                 f"{eager[i][3]}) for {steps} steps")
        check_history(f"device sampling {name}", res)
        if card:
            check_graphs(f"device sampling {name}", res.extras, most)
        ledger = (res.extras["transfers_h2d"], res.extras["transfers_d2h"])
        if ledger != (1, 1):
            fail(f"device sampling {name}: transfer ledger {ledger}")
        graph_vs_eager = max(
            _max_abs(res.history.objective, eres.history.objective),
            _max_abs(res.history.consensus, eres.history.consensus),
            _max_abs(res.params.cpu(), eres.params.cpu()))
        if graph_vs_eager != 0.0:
            fail(f"device sampling {name}: CUDA graphs differ from the "
                 f"eager executor by {graph_vs_eager}")
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(cres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"device sampling {name} {col}: card vs CPU")
        obj, hobj = res.history.objective, hres.history.objective
        descent = hobj[0] - hobj[-1]
        if not (descent > 0 and abs(obj[-1] - hobj[-1]) < descent / 3):
            fail(f"device sampling {name}: final objective {obj[-1]} out "
                 f"of the host-sampled run's envelope ({hobj[0]} -> "
                 f"{hobj[-1]})")
        dev_s = (dev1[i][4] + dev2[i][4]) / 2
        host_s = (host1[i][4] + host2[i][4]) / 2
        rows[name] = {
            "steps": steps, "launches": n,
            "objective_first": float(obj[0]),
            "objective_last": float(obj[-1]),
            "host_sampled_objective_last": float(hobj[-1]),
            "max_abs_objective_vs_cpu": _max_abs(obj, cres.history.objective),
            "max_abs_params_vs_cpu": _max_abs(res.params.cpu(),
                                              cres.params.cpu()),
            "max_abs_graph_vs_eager": graph_vs_eager,
            "ms_per_step": dev_s / steps * 1e3,
            "host_sampled_ms_per_step": host_s / steps * 1e3,
            "device_vs_host_sampling": dev_s / host_s,
            "graphs_built": res.extras["graphs_built"], "max_graphs": most,
            "replays": res.extras["replays"],
            "transfers": list(ledger)}
        print(f"device_sampling {name}: {rows[name]['ms_per_step']:.4f} ms "
              f"a step (host sampling "
              f"{rows[name]['host_sampled_ms_per_step']:.4f}), objective "
              f"{obj[-1]:.7f} (host sampling {hobj[-1]:.7f})", flush=True)
    if card:
        rows["profile_device_sampling"] = profile_main_path(parts, dim,
                                                            "device")
        rows["profile_host_sampling"] = profile_main_path(parts, dim)
    return rows, launches


def _scan_path(parts, dim, device) -> dict:
    """(b) DSPG through scan=True against the host loop on ``device``."""
    cfg = paper_logreg.CONFIG
    problem = _scenario_problem(parts, dim, device)
    sched = graphs.b_connected_ring_schedule(cfg.num_nodes, 1)

    def make():
        return algorithm.dspg_algorithm(
            problem, algorithm.DSPGHyperParams(alpha0=cfg.alpha),
            EXEC_SCAN_STEPS)

    out = {}
    for name, spec in (("scan", ExecSpec(scan=True, gossip="dense",
                                         device=device)),
                       ("host", ExecSpec(gossip="dense", device=device))):
        algo = make()
        before = runner.scan_executable_count(algo)
        # a warm run, then the best of three (of one for the host loop,
        # whose 600 per-step uploads take seconds)
        runs = 4 if name == "scan" else 2
        secs = []
        for _ in range(runs):
            _sync(device)
            t0 = time.perf_counter()
            res = runner.run(algo, problem, sched, spec,
                             record_every=EXEC_SCAN_RECORD)
            _sync(device)
            secs.append(time.perf_counter() - t0)
        out[name] = (res, min(secs[1:]),
                     (runner.scan_executable_count(algo) - before) // runs)
    (scan, scan_s, pieces), (host, host_s, _) = out["scan"], out["host"]
    check_history("scan_path", scan)
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(
            getattr(scan.history, col), getattr(host.history, col),
            rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
            err_msg=f"scan_path {col}: scan vs host loop on the card")
    np.testing.assert_array_equal(scan.history.steps, host.history.steps)
    records = EXEC_SCAN_STEPS // EXEC_SCAN_RECORD + 1
    ledger = (scan.extras["transfers_h2d"], scan.extras["transfers_d2h"])
    if ledger != (records - 1, 2 * records):
        fail(f"scan_path: transfer ledger {ledger}, want "
             f"{(records - 1, 2 * records)}")
    most = max_graphs(make().meta, EXEC_SCAN_RECORD)
    if device != "cpu":
        check_graphs("scan_path", scan.extras, most)
        if pieces != scan.extras["graphs_built"]:
            fail(f"scan_path: scan_executable_count {pieces}, graphs "
                 f"{scan.extras['graphs_built']}")
    row = {"steps": EXEC_SCAN_STEPS, "record_every": EXEC_SCAN_RECORD,
           "ms_per_step": scan_s / EXEC_SCAN_STEPS * 1e3,
           "host_loop_ms_per_step": host_s / EXEC_SCAN_STEPS * 1e3,
           "max_abs_objective_vs_host_loop": _max_abs(
               scan.history.objective, host.history.objective),
           "transfers": list(ledger),
           "host_loop_transfers": [host.extras["transfers_h2d"],
                                   host.extras["transfers_d2h"]],
           "graphs_built": scan.extras["graphs_built"], "max_graphs": most,
           "scan_executable_count": pieces,
           "replays": scan.extras["replays"]}
    print("scan_path " + json.dumps(row), flush=True)
    return row


def _device_sampled_sweeps(device, scale: float) -> tuple:
    """(c) Fig. 4's lambda grid batched with device sampling through the
    cell-batched fused_step (counts set to 0 before, read after: one launch
    a step for all cells), each cell held to its sequential device-sampled
    run at phase 15's tolerances."""
    from benchmarks import pt_fig4_lambda
    rows, launches = {}, 0
    for method, sw in pt_fig4_lambda.sweeps(scale, device).items():
        name = f"fig4/{method}"
        spec = ExecSpec(resident=True, sampling="device", kernel="fused",
                        gossip="dense", device=device)
        kw = dict(record_every=sw.record_every)
        _reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        bat = sweep.run_sweep(sw.build, sw.grid, sw.sched, spec, **kw)
        _sync(device)
        bat_s = time.perf_counter() - t0
        n = ops.launches_cells
        launches += n
        cells = bat.history.objective.shape[1]
        steps = int(bat.history.steps[-1, 0])
        meta = sw.build()[0].meta
        if device != "cpu":
            if n != steps:
                fail(f"{name} device sampling: {n} cell-batched fused_step "
                     f"launches for {steps} steps of {cells} cells")
            check_graphs(name, bat.extras, max_graphs(meta, sw.record_every))
        ledger = (bat.extras["transfers_h2d"], bat.extras["transfers_d2h"])
        if ledger != (1, 1):
            fail(f"{name} device sampling: transfer ledger {ledger}")
        _sync(device)
        t0 = time.perf_counter()
        seq = sweep.run_sweep(sw.build, sw.grid, sw.sched, spec,
                              batched=False, **kw)
        _sync(device)
        seq_s = time.perf_counter() - t0
        diff = _sweeps_agree(f"{name} device sampling", seq, bat)
        rows[name] = {"cells": cells, "steps": steps, "launches": n,
                      "batched_ms_per_cell_step": bat_s / cells / steps
                      * 1e3,
                      "sequential_ms_per_cell_step": seq_s / cells / steps
                      * 1e3,
                      "max_abs_objective_batched_vs_sequential": diff,
                      "graphs_built": bat.extras["graphs_built"],
                      "objective_last": bat.history.objective[-1].tolist()}
        print(f"sweep_device_sampling {name}: {json.dumps(rows[name])}",
              flush=True)
    return rows, launches


def _sweep_train_setup(cfg, device):
    tokens = synthetic.make_token_stream(TRAIN_TOKENS, cfg.vocab_size,
                                         seed=0).tokens
    sched = graphs.b_connected_ring_schedule(TRAIN_NODES, b=2, seed=0)

    def loader():
        return LMLoader(tokens, num_nodes=TRAIN_NODES,
                        per_node_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)

    return sched, loader


def _alloc_retries(device) -> int:
    """The caching allocator's cudaMalloc retries so far (each one frees
    the cache and synchronizes the card)."""
    if device == "cpu":
        return 0
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def _traced_lm_steps(cfg, device, sched, loader) -> dict:
    """Where the card's time goes in train_sweep's cell-vmapped step and in
    train_loop's step: each traced over 3 steps (a refresh at the first;
    both already ran in this process), the union of the kernels' intervals
    against the wall time, and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile
    tc = trainer.TrainerConfig(algorithm="dpsvrg", **dict(
        SWEEP_TRAIN_TC, num_steps=3))
    runs = {
        "train_sweep": lambda: trainer.train_sweep(
            cfg, prox.l1, sched, loader(), tc, SWEEP_TRAIN_GRID,
            ExecSpec(resident=True, device=device), mode=SWEEP_TRAIN_MODE),
        "train_loop": lambda: trainer.train_loop(
            cfg, prox.l1(SWEEP_TRAIN_GRID["lam"][0]), sched, loader(), tc,
            exec=ExecSpec(resident=True, device=device))}
    out = {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        out[name] = device_busy(prof, wall_us)
        del prof
        _free_card()
    return out


def _train_sweep(cfg, device) -> dict:
    """(d) train_sweep of a lambda x alpha grid (two cells) at full width,
    each cell's losses held to a sequential resident train_loop of that
    cell; ms a cell-step batched and sequential, the peak memory, the
    allocator's retries, and (on the card) traced steps of both."""
    sched, loader = _sweep_train_setup(cfg, device)
    tc = trainer.TrainerConfig(algorithm="dpsvrg", **SWEEP_TRAIN_TC)
    _free_card()
    _peak_reset(device)
    retries = _alloc_retries(device)
    t0 = time.perf_counter()
    res = trainer.train_sweep(cfg, prox.l1, sched, loader(), tc,
                              SWEEP_TRAIN_GRID,
                              ExecSpec(resident=True, device=device),
                              mode=SWEEP_TRAIN_MODE)
    _sync(device)
    bat_s = time.perf_counter() - t0
    peak = _peak(device)
    retries = _alloc_retries(device) - retries
    grid, loss = res["grid"], np.asarray(res["loss"])
    steps = SWEEP_TRAIN_TC["num_steps"]
    if res["transfers"] != {"h2d": 1, "d2h": 1}:
        fail(f"train_sweep: transfers {res['transfers']}")
    if len(grid) < 2 or not np.all(np.isfinite(loss)):
        fail(f"train_sweep: {len(grid)} cells, losses {loss.tolist()}")
    del res
    _free_card()
    seq_s, seq_peak, diff = 0.0, 0, 0.0
    seq_retries = _alloc_retries(device)
    for i, cell in enumerate(grid):
        tci = trainer.TrainerConfig(algorithm="dpsvrg", **dict(
            SWEEP_TRAIN_TC, alpha=cell["alpha"]))
        _peak_reset(device)
        t0 = time.perf_counter()
        hist = trainer.train_loop(cfg, prox.l1(cell["lam"]), sched, loader(),
                                  tci, exec=ExecSpec(resident=True,
                                                     device=device))
        _sync(device)
        seq_s += time.perf_counter() - t0
        seq_peak = max(seq_peak, _peak(device))
        np.testing.assert_allclose(
            loss[:, i], hist["loss"], **TRAIN_LOSS_TOL,
            err_msg=f"train_sweep cell {cell} vs sequential train_loop")
        diff = max(diff, _max_abs(loss[:, i], hist["loss"]))
        del hist
        _free_card()
    seq_retries = _alloc_retries(device) - seq_retries
    row = {"layers": cfg.num_layers, "cells": len(grid), "grid": grid,
           "mode": SWEEP_TRAIN_MODE, "steps": steps,
           "per_node_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "batched_ms_per_cell_step": bat_s / steps / len(grid) * 1e3,
           "sequential_ms_per_cell_step": seq_s / steps / len(grid) * 1e3,
           "max_memory_allocated_bytes": peak,
           "sequential_max_memory_allocated_bytes": seq_peak,
           "alloc_retries": retries, "sequential_alloc_retries": seq_retries,
           "max_abs_loss_vs_sequential": diff,
           "loss_first": loss[0].tolist(), "loss_last": loss[-1].tolist(),
           "transfers": {"h2d": 1, "d2h": 1}}
    if device != "cpu":
        row["profile"] = _traced_lm_steps(cfg, device, sched, loader)
    print("train_sweep " + json.dumps(row), flush=True)
    return row


def _train_device_sampling(cfg, device, work) -> dict:
    """(e) train_loop(resident, sampling="device") at the same size, one
    cell: 10 steps uninterrupted, and a run stopped at step 5 with its
    checkpoint (the same TrainerConfig but for ``num_steps``, which a
    constant step size does not read; one 10.6 GB save instead of the two
    of a 10-step run that checkpoints every 5 steps) resumed to step 10:
    bitwise the uninterrupted run, records and every state leaf."""
    sched, loader = _sweep_train_setup(cfg, device)
    lam = SWEEP_TRAIN_GRID["lam"][0]
    ckpt_dir = os.path.join(work, "device_sampling")
    spec = ExecSpec(resident=True, sampling="device", device=device)
    _peak_reset(device)
    t0 = time.perf_counter()
    full = trainer.train_loop(
        cfg, prox.l1(lam), sched, loader(),
        trainer.TrainerConfig(algorithm="dpsvrg", **SWEEP_TRAIN_TC),
        exec=spec)
    _sync(device)
    full_s = time.perf_counter() - t0
    peak = _peak(device)
    if not np.all(np.isfinite(full["loss"])):
        fail(f"train device sampling: losses {full['loss']}")
    records = dict(zip(full["step"], full["loss"]))
    state = [(k, v.cpu()) for k, v in
             checkpoint.flatten_with_paths(full["final_state"])]
    full_loss, transfers = full["loss"], full["transfers"]
    del full
    _free_card()
    tc = trainer.TrainerConfig(algorithm="dpsvrg", ckpt_dir=ckpt_dir,
                               **SWEEP_TRAIN_TC)
    t0 = time.perf_counter()
    stopped = trainer.train_loop(
        cfg, prox.l1(lam), sched, loader(),
        dataclasses.replace(tc, num_steps=DEVICE_TRAIN_CKPT_STEP), exec=spec)
    stopped_s = time.perf_counter() - t0
    if checkpoint.latest_step(ckpt_dir) != DEVICE_TRAIN_CKPT_STEP or \
            stopped["loss"] != full_loss[:DEVICE_TRAIN_CKPT_STEP]:
        fail(f"train device sampling: the stopped run's records "
             f"{stopped['loss']} differ from the uninterrupted run's")
    del stopped
    _free_card()
    t0 = time.perf_counter()
    resumed = trainer.train_loop(cfg, prox.l1(lam), sched, loader(), tc,
                                 exec=spec, resume=True)
    _sync(device)
    resumed_s = time.perf_counter() - t0
    want = list(range(DEVICE_TRAIN_CKPT_STEP, SWEEP_TRAIN_TC["num_steps"]))
    if resumed["step"] != want or \
            [records[s] for s in want] != resumed["loss"]:
        fail(f"train device sampling resume: records {resumed['step']} "
             f"{resumed['loss']} differ from the uninterrupted run's")
    got = checkpoint.flatten_with_paths(resumed["final_state"])
    for (k, leaf), (k2, mine) in zip(state, got):
        if k != k2 or not torch.equal(mine.cpu(), leaf):
            fail(f"train device sampling resume: state leaf {k} differs")
    del resumed, got, state
    _free_card()
    row = {"steps": SWEEP_TRAIN_TC["num_steps"], "loss": full_loss,
           "run_s": full_s, "stopped_run_s": stopped_s,
           "resumed_run_s": resumed_s,
           "max_memory_allocated_bytes": peak, "transfers": transfers,
           "resume_bitwise": True}
    print("train_device_sampling " + json.dumps(row), flush=True)
    return row


def exec_modes_phase(parts, dim: int, device="cuda", scale=FIG_SCALE,
                     cfg=None) -> dict:
    """Phase 19.  Returns the phase's numbers, the fused_step launches of
    its device-sampled main path and of its device-sampled sweeps among
    them.  To rehearse it on the CPU: ``device="cpu"``, the main path's
    data at a small scale, a small ``scale`` and a smoke ``cfg`` (launch
    counts, graphs and peaks are not checked off the card)."""
    if cfg is None:
        cfg = configs.get_config("h2o-danube-1.8b").scaled(
            num_layers=SWEEP_TRAIN_LAYERS)
    out, times = {}, {}
    t0 = time.perf_counter()
    out["device_sampling"], main_launches = _device_sampled_main_path(
        parts, dim, device)
    times["device_sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["scan_path"] = _scan_path(parts, dim, device)
    times["scan_path"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sweep_device_sampling"], cell_launches = _device_sampled_sweeps(
        device, scale)
    times["sweep_device_sampling"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["train_sweep"] = _train_sweep(cfg, device)
    times["train_sweep"] = time.perf_counter() - t0
    work = os.path.join(ROOT, "build", "phase19")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        out["train_device_sampling"] = _train_device_sampling(cfg, device,
                                                              work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    times["train_device_sampling"] = time.perf_counter() - t0
    out["seconds"] = times
    out["launches"] = {"fused_step": main_launches,
                       "fused_step_cells": cell_launches}
    print("exec_modes " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 21-24: stablelm-12b and the llama4 MoE configs at full width, and
# MoE training at smoke size
# ---------------------------------------------------------------------------

MOE_SEED = 0
# stablelm-12b at full depth: 40 layers of layernorm and qk-norm attention
# at head_dim 160, 12.1 B parameters (48.6 GB of float32 weights), phase
# 11's requests and engine (a 10.2 GB cache at head_dim 160)
# llama4-scout-17b-a16e cut from 48 to 4 layers (9.84 B parameters, 39.4
# GB of float32): layers 0-2 chunked-local (the plain attention path),
# layer 3 global with NoPE (flash); a 16-expert MoE with a shared expert
# on every layer
SCOUT_LAYERS = 4
# stablelm-12b cut from 40 to 10 layers (at full depth, 48.6 GB and a
# 67.8 GB peak, it took 114 s of the script; 10 keep the script within its
# time limit since phases 25-26 came)
STABLELM_LAYERS = 10
# llama4-maverick-400b-a17b cut from 48 to 2 layers, bf16 (17.5 B
# parameters, 35.0 GB; float32 would not fit): layer 0 dense, layer 1 a
# 128-expert MoE; both chunked-local, so no flash launch
MAVERICK_LAYERS = 2
MAVERICK_PROMPTS = [256, 512, 1024, 2048, 256, 512, 1024, 2048]
MAVERICK_NEW = 16
MAVERICK_MAX_LEN = 2112
# a short Poisson stream through each model's engine (TTFT, TPOT)
MOE_STREAM = dict(num_requests=4, prompt_lens=(512, 2048), new_low=16,
                  new_high=32)
# one scout MoE layer at full width on the card against the CPU: routing
# exactly equal, the output within 1e-4 of its largest magnitude (float32
# products summed in other orders by cuBLAS and the CPU's BLAS)
MOE_LAYER_TOKENS = 512
MOE_LAYER_RTOL = 1e-4
# the MoE training case: scout's smoke variant at 4 layers (a global NoPE
# layer among them), m = 4 on the b=2 ring, resident, a checkpoint at
# step 6 of 12
MOE_TRAIN_TC = dict(num_steps=12, snapshot_every=5, log_every=3,
                    alpha=0.05, seed=0)
MOE_TRAIN_CKPT_EVERY = 6
# a card step against the CPU's step from the same state: the parameter
# tolerance of tests/test_torch_train.py
MOE_PARAM_ATOL = 1e-4
# xlstm's training case: its smoke variant cut from 4 to 2 layers (one
# mLSTM and one sLSTM block; its time loops, a Python step a token a block,
# in float32 and float64 on the CPU took 102 s of the script at 4)
XLSTM_TRAIN_LAYERS = 2


def _moe_stream(vocab: int) -> serve_stream.StreamConfig:
    """A short seeded Poisson stream for the engines of phases 21-23."""
    return serve_stream.StreamConfig(vocab_size=vocab, arrival="poisson",
                                     rate=STREAM_RATE, seed=MOE_SEED,
                                     **MOE_STREAM)


def _moe_layer_vs_cpu(cfg, params, device) -> dict:
    """Layer 0's MoE at full width on a 512-token input, on the card and on
    the CPU: routing exactly equal, the output within MOE_LAYER_RTOL of its
    largest magnitude; the tokens dropped per expert."""
    spec = transformer.layer_plan(cfg)[0].moe
    lp = params["layers"][0]["moe"]
    gen = torch.Generator(device=device).manual_seed(MOE_SEED)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device=device)
    y, aux = moe.moe_forward(lp, spec, x)
    routing = [t.cpu() for t in moe.route(lp, spec, x[0])]
    cpu_p = {k: v.cpu() for k, v in lp.items()}
    t0 = time.perf_counter()
    yc, auxc = moe.moe_forward(cpu_p, spec, x.cpu())
    cpu_s = time.perf_counter() - t0
    routing_c = moe.route(cpu_p, spec, x[0].cpu())
    del cpu_p
    for name, got, want in zip(("experts", "slots", "keep"), routing[2:],
                               routing_c[2:]):
        if not torch.equal(got, want):
            fail(f"moe layer: {name} differ between the card and the CPU "
                 f"at {int((got != want).sum())} places")
    err = float((y.cpu() - yc).abs().max())
    scale = float(yc.abs().max())
    if not err <= MOE_LAYER_RTOL * scale:
        fail(f"moe layer: card vs CPU max abs err {err:.3g} over "
             f"{MOE_LAYER_RTOL} of the largest |y| {scale:.3g}")
    experts, keep = routing[2], routing[4]
    return {"tokens": MOE_LAYER_TOKENS, "experts": spec.num_experts,
            "capacity": moe.capacity(spec, MOE_LAYER_TOKENS),
            "max_abs_err": err, "max_abs_y": scale,
            "aux": float(aux), "aux_cpu": float(auxc),
            "dropped_per_expert": torch.bincount(
                experts[~keep], minlength=spec.num_experts).tolist(),
            "cpu_s": cpu_s}


def stablelm_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 21: stablelm-12b at full width, STABLELM_LAYERS deep, float32,
    flash on (every layer at head_dim 160; its norms are LayerNorm, not a
    kernel)."""
    if cfg is None:
        cfg = configs.get_config("stablelm-12b").scaled(
            num_layers=STABLELM_LAYERS)
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, MOE_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    result = serve_model(
        "stablelm", cfg, params, danube_requests(cfg.vocab_size),
        slots=DANUBE_SLOTS, max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=cfg.num_layers, rms_per_forward=0,
        stream=_moe_stream(cfg.vocab_size), device=device)
    result.update(layers=cfg.num_layers,
                  params=transformer.param_count(params), init_s=init_s)
    del params
    _free_card()
    print("stablelm_serve " + json.dumps(result), flush=True)
    return result


def scout_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 22: llama4-scout-17b-a16e at full width, 4 layers, float32,
    flash and RMSNorm on; then one MoE layer held to the CPU."""
    if cfg is None:
        cfg = configs.get_config("llama4-scout-17b-a16e").scaled(
            num_layers=SCOUT_LAYERS)
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, MOE_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    flash_layers = sum(p.attn.chunk is None
                       for p in transformer.layer_plan(cfg))
    result = serve_model(
        "scout", cfg, params, danube_requests(cfg.vocab_size),
        slots=DANUBE_SLOTS, max_len=DANUBE_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=flash_layers,
        rms_per_forward=2 * cfg.num_layers + 1,
        stream=_moe_stream(cfg.vocab_size), device=device)
    result.update(layers=cfg.num_layers,
                  params=transformer.param_count(params), init_s=init_s)
    result["moe_layer_vs_cpu"] = _moe_layer_vs_cpu(cfg, params, device)
    del params
    _free_card()
    print("scout_serve " + json.dumps(result), flush=True)
    return result


def maverick_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 23: llama4-maverick-400b-a17b at full width, 2 layers, bf16,
    RMSNorm on (no layer is global, so flash does not run)."""
    if cfg is None:
        cfg = configs.get_config("llama4-maverick-400b-a17b").scaled(
            num_layers=MAVERICK_LAYERS)
    cfg = cfg.scaled(param_dtype="bfloat16", use_flash=True,
                     use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, MOE_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    flash_layers = sum(p.attn.chunk is None
                       for p in transformer.layer_plan(cfg))
    reqs = _requests(cfg.vocab_size, MAVERICK_PROMPTS, MAVERICK_NEW,
                     MOE_SEED)
    result = serve_model(
        "maverick", cfg, params, reqs, slots=DANUBE_SLOTS,
        max_len=MAVERICK_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=flash_layers,
        rms_per_forward=2 * cfg.num_layers + 1,
        stream=_moe_stream(cfg.vocab_size), device=device)
    result.update(layers=cfg.num_layers,
                  params=transformer.param_count(params), init_s=init_s,
                  decode_capacity=moe.capacity(
                      transformer.layer_plan(cfg)[1].moe, DANUBE_SLOTS))
    del params
    _free_card()
    print("maverick_serve " + json.dumps(result), flush=True)
    return result


def _smoke_train_run(cfg, device, ckpt_dir=None, resume=False,
                     init_scale=1.0):
    """train_loop of ``cfg`` on ``device``, resident, from parameters drawn
    on the CPU (so the card and the CPU start from the same point), each
    times ``init_scale``."""
    toks = synthetic.make_token_stream(50_000, cfg.vocab_size, seed=0)
    ld = LMLoader(toks.tokens, num_nodes=4, per_node_batch=2, seq_len=32,
                  seed=1)
    tc = trainer.TrainerConfig(
        ckpt_dir=ckpt_dir, ckpt_every=MOE_TRAIN_CKPT_EVERY if ckpt_dir
        else 0, **MOE_TRAIN_TC)
    init = transformer.init_params
    steps.transformer.init_params = \
        lambda cfg_, seed, device: pytree.tree_map(
            lambda t: (t * init_scale).to(device), init(cfg_, seed, "cpu"))
    try:
        return trainer.train_loop(
            cfg, prox.l1(1e-6), graphs.b_connected_ring_schedule(
                4, b=2, seed=0), ld, tc,
            exec=ExecSpec(resident=True, device=device), resume=resume)
    finally:
        steps.transformer.init_params = init


def _steps_vs_cpu(cfg, device, float64=False) -> dict:
    """The trainer's DPSVRG step on the card from the CPU run's state, step
    by step (snapshot refreshes at MOE_TRAIN_TC's steps): each card step
    equals the CPU's within TRAIN_LOSS_TOL in the loss and MOE_PARAM_ATOL
    in every parameter (a chaotic run is held no other way: a last-bit
    difference grows from step to step).  With ``float64`` (an
    ill-conditioned model) the same step also runs in float64 on the CPU,
    and a parameter is held where the CPU's float32 step lies within a
    quarter of MOE_PARAM_ATOL of it (where float32 determines the step)
    and recorded elsewhere.  Returns the largest differences."""
    bundle = steps.build_train_step(cfg, prox.l1(1e-6), 4,
                                    algorithm="dpsvrg")
    if float64:
        cfg64 = cfg.scaled(param_dtype="float64", logit_dtype="float64")
        with pt_common.float64_models():
            bundle64 = steps.build_train_step(cfg64, prox.l1(1e-6), 4,
                                              algorithm="dpsvrg")
    toks = synthetic.make_token_stream(50_000, cfg.vocab_size, seed=0)
    ld = LMLoader(toks.tokens, num_nodes=4, per_node_batch=2, seq_len=32,
                  seed=1)
    sched = graphs.b_connected_ring_schedule(4, b=2, seed=0)

    def batch_of(arrays):
        return {k: torch.from_numpy(v) for k, v in
                zip(("tokens", "labels"), arrays)}

    def moved(tree, where):
        return pytree.tree_map(
            lambda t: None if t is None else t.to(where), tree)

    state = bundle.init_state(0, "cpu")
    worst = 0.0
    held, recorded = [], []
    for k in range(MOE_TRAIN_TC["num_steps"]):
        if k % MOE_TRAIN_TC["snapshot_every"] == 0:
            state = bundle.snapshot_step(
                state, batch_of(ld.gather(ld.sample_starts(8))))
        batch = batch_of(ld.sample())
        phi = torch.as_tensor(sched.consensus_rounds(k, 2),
                              dtype=torch.float32)
        alpha = MOE_TRAIN_TC["alpha"]
        card, card_m = bundle.train_step(moved(state, device),
                                         moved(batch, device),
                                         phi.to(device), alpha)
        if float64:
            with pt_common.float64_models():
                want64 = bundle64.train_step(
                    pytree.tree_map(lambda t: t if t is None or
                                    not t.is_floating_point()
                                    else t.double(), state),
                    batch, phi.double(), alpha)[0].params
        state, m = bundle.train_step(state, batch, phi, alpha)
        np.testing.assert_allclose(float(card_m["loss"]), float(m["loss"]),
                                   **TRAIN_LOSS_TOL,
                                   err_msg=f"train step {k}: card vs CPU")
        worst = max(worst, abs(float(card_m["loss"]) - float(m["loss"])))
        for (key, a), (_, b) in zip(
                checkpoint.flatten_with_paths(card.params),
                checkpoint.flatten_with_paths(state.params)):
            err = float((a.cpu() - b).abs().max())
            if float64:
                w = dict(checkpoint.flatten_with_paths(want64))[key]
                e_cpu = float((b.double() - w).abs().max())
                if e_cpu > MOE_PARAM_ATOL / 4:
                    recorded.append((err, e_cpu))
                    continue
            held.append(err)
            if not err <= MOE_PARAM_ATOL:
                fail(f"train step {k}: {key} card vs CPU {err:.3g}")
    out = {"max_abs_step_loss_vs_cpu": worst,
           "max_abs_param_err_held": max(held), "held": len(held)}
    if float64:
        out.update(recorded=len(recorded), max_abs_param_err_recorded=max(
            (e for e, _ in recorded), default=0.0),
            max_abs_cpu_vs_float64_recorded=max(
                (e for _, e in recorded), default=0.0))
    return out


def moe_train_phase(device="cuda") -> dict:
    """Phase 24: scout's smoke variant at 4 layers trained on the card with
    the aux in the loss: each step held to the CPU's step from the same
    state, two runs bit for bit equal, a resume from step 6 bitwise the
    uninterrupted run.  Whole runs on the card and the CPU are not held to
    each other: routing is discontinuous, and a last-bit difference that
    flips one token's expert moves the loss by 1e-3 a few steps later.
    Their gap is printed, beside the CPU's own gap to a CPU run from the
    init scaled by 1 + 1e-7."""
    cfg = configs.smoke_variant(configs.get_config(
        "llama4-scout-17b-a16e")).scaled(num_layers=4)
    work = os.path.join(ROOT, "build", "phase24")
    shutil.rmtree(work, ignore_errors=True)
    try:
        step_err = _steps_vs_cpu(cfg, device)["max_abs_step_loss_vs_cpu"]
        cpu = _smoke_train_run(cfg, "cpu")
        cpu_scaled = _smoke_train_run(cfg, "cpu", init_scale=1 + 1e-7)
        full = _smoke_train_run(cfg, device,
                                ckpt_dir=os.path.join(work, "a"))
        twin = _smoke_train_run(cfg, device)
        if full["step"] != cpu["step"]:
            fail(f"moe train: records {full['step']} vs {cpu['step']}")
        if twin["loss"] != full["loss"] or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    checkpoint.flatten_with_paths(twin["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"]))):
            fail("moe train: a second run is not bit for bit the first")
        shutil.rmtree(os.path.join(work, "a", "step_00000012"))
        res = _smoke_train_run(cfg, device,
                               ckpt_dir=os.path.join(work, "a"), resume=True)
        by_step = dict(zip(full["step"], full["loss"]))
        if res["step"] != [6, 9, 11] or \
                [by_step[s] for s in res["step"]] != res["loss"]:
            fail(f"moe train resume: records {res['step']} {res['loss']}")
        for (k, a), (_, b) in zip(
                checkpoint.flatten_with_paths(res["final_state"]),
                checkpoint.flatten_with_paths(full["final_state"])):
            if not torch.equal(a, b):
                fail(f"moe train resume: state leaf {k} differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not np.all(np.isfinite(full["loss"])):
        fail(f"moe train: losses {full['loss']}")
    result = {"steps": full["step"], "loss": full["loss"],
              "cpu_loss": cpu["loss"], "cpu_scaled_init_loss":
              cpu_scaled["loss"],
              "max_abs_step_loss_vs_cpu": step_err,
              "max_abs_run_loss_vs_cpu": _max_abs(full["loss"], cpu["loss"]),
              "max_abs_run_loss_cpu_vs_scaled_init": _max_abs(
                  cpu_scaled["loss"], cpu["loss"]),
              "twin_bitwise": True, "resume_bitwise": True,
              "transfers": full["transfers"]}
    print("moe_train " + json.dumps(result), flush=True)
    return result

def xlstm_train_phase(device="cuda") -> dict:
    """Phase 24, its SSM part: xlstm-350m's smoke variant at
    XLSTM_TRAIN_LAYERS layers (an mLSTM and an sLSTM block, their time
    loops under the node vmap) trained on the card: each step held to the
    CPU's step from the same
    state, two runs bit for bit equal, a resume from step 6 bitwise the
    uninterrupted run.  Whole runs are not held to the CPU's: xlstm's
    training is chaotic at this size (tests/test_torch_train.py), and a
    step's parameters are held where float32 determines them (the CPU's
    step within MOE_PARAM_ATOL / 4 of the same step in float64)."""
    cfg = configs.smoke_variant(configs.get_config("xlstm-350m")).scaled(
        num_layers=XLSTM_TRAIN_LAYERS)
    work = os.path.join(ROOT, "build", "phase24_xlstm")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        step_check = _steps_vs_cpu(cfg, device, float64=True)
        steps_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = _smoke_train_run(cfg, device,
                                ckpt_dir=os.path.join(work, "a"))
        run_s = time.perf_counter() - t0
        twin = _smoke_train_run(cfg, device)
        if twin["loss"] != full["loss"] or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(
                    checkpoint.flatten_with_paths(twin["final_state"]),
                    checkpoint.flatten_with_paths(full["final_state"]))):
            fail("xlstm train: a second run is not bit for bit the first")
        shutil.rmtree(os.path.join(work, "a", "step_00000012"))
        res = _smoke_train_run(cfg, device,
                               ckpt_dir=os.path.join(work, "a"), resume=True)
        by_step = dict(zip(full["step"], full["loss"]))
        if res["step"] != [6, 9, 11] or \
                [by_step[s] for s in res["step"]] != res["loss"]:
            fail(f"xlstm train resume: records {res['step']} {res['loss']}")
        for (k, a), (_, b) in zip(
                checkpoint.flatten_with_paths(res["final_state"]),
                checkpoint.flatten_with_paths(full["final_state"])):
            if not torch.equal(a, b):
                fail(f"xlstm train resume: state leaf {k} differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if not np.all(np.isfinite(full["loss"])):
        fail(f"xlstm train: losses {full['loss']}")
    result = {"layers": cfg.num_layers, "steps": full["step"],
              "loss": full["loss"], "steps_vs_cpu": step_check,
              "steps_vs_cpu_s": steps_s, "run_s": run_s,
              "twin_bitwise": True, "resume_bitwise": True,
              "transfers": full["transfers"]}
    print("xlstm_train " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phases 25-26: the SSM models at full width: xlstm-350m, jamba-1.5-large
# ---------------------------------------------------------------------------

SSM_SEED = 0
# xlstm-350m at full width and depth (24 blocks, 391.7 M parameters, 1.57
# GB float32): short prompts, since the eager time loop runs about 25
# operations a token a block (12 ms a token on the card; prompts of
# 128-512 tokens took 106 s of the script, so they are cut to 32-128); no
# KV cache, so max_len only bounds prompts
XLSTM_PROMPTS = [32, 64, 96, 128, 32, 64, 96, 128]
XLSTM_NEW = 16
XLSTM_MAX_LEN = 160
XLSTM_STREAM = dict(num_requests=4, prompt_lens=(32, 128), new_low=16,
                    new_high=32)
# xlstm's float32 logits at random init are mostly not determined to 1e-3:
# on a 128-token prompt the card's plain and kernel paths and the CPU each
# leave the float64 run by more than 1e-3 from position 6 on, by up to 1.8,
# and on some prompts sooner (its mLSTM normalizer max(|n.q|, exp(-m)) has
# poles where n.q crosses 0 from the second position on).  So its logits
# are held, on each prompt's first XLSTM_PREFIX positions (the prefill of
# one token, then teacher-forced decode steps), where float32 determines
# them: at position 0 always, elsewhere where the plain path lies within
# DETERMINED_SHARE of the tolerance from the float64 run; they are
# recorded on the whole prompts
XLSTM_PREFIX = 6
DETERMINED_SHARE = 0.25
# jamba-1.5-large at full width cut from 72 to 2 layers (11.38 B
# parameters, 45.5 GB float32): layer 0 attention (flash, 64/8 heads at
# head_dim 128) with a dense swiglu FFN, layer 1 Mamba with a 16-expert
# top-2 MoE; 4 layers would take 89.9 GB
JAMBA_LAYERS = 2
JAMBA_PROMPTS = [256, 512, 1024, 2048, 256, 512, 1024, 2048]
JAMBA_NEW = 16
JAMBA_MAX_LEN = 2112
JAMBA_STREAM = dict(num_requests=4, prompt_lens=(256, 2048), new_low=16,
                    new_high=32)
# one full-width mixer layer on the card against the same layer on the
# CPU: mLSTM and sLSTM on 128 tokens, Mamba on 512; float32 products in
# other orders, held within 1e-4 of the output's largest magnitude (the
# mLSTM, ill-conditioned, also against its float64 run on the CPU)
SSM_LAYER_TOKENS = {"mlstm": 128, "slstm": 128, "mamba": 512}
SSM_LAYER_RTOL = 1e-4



def _float64_yardstick(cfg, params, max_len: int):
    """``yardstick(toks, fed)`` for ``_prefix_check``: the plain path in
    float64 on the card, prefill then the fed tokens decoded."""
    cfg64 = cfg.scaled(param_dtype="float64", logit_dtype="float64",
                       use_flash=False, use_fused_norm=False)
    p64 = pytree.tree_map(lambda t: t.double(), params)

    def run(toks, fed):
        with pt_common.float64_models():
            lg, cache = transformer.prefill(cfg64, p64, toks,
                                            max_len=max_len)
            out = [lg]
            for tok in fed:
                lg, cache = transformer.decode_step(
                    cfg64, p64, cache, torch.tensor(
                        [tok], dtype=torch.int32, device=toks.device))
                out.append(lg)
        return torch.stack(out)

    return run


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree))


def _state_bytes(cfg, slots: int, max_len: int) -> int:
    cache = transformer.init_cache(cfg, slots, max_len, device="meta")
    return sum(t.numel() * t.element_size()
               for t in pytree.tree_leaves(cache["layers"]))


def _decode_profile(cfg, params, reqs, slots: int, max_len: int,
                    device, weights=None) -> dict:
    """One decode step of ``slots`` admitted rows, traced: the card's busy
    time and idle share; and the step's bound, its weights (``weights``
    bytes where given, else all of ``params``) read once and its states
    (KV caches or recurrent states, cross-attention K/V) read and written
    once at the memory rate."""
    from torch.profiler import ProfilerActivity, profile
    eng = ResidentEngine(cfg, params, max_slots=slots, max_len=max_len,
                         chunk=1)
    for r in reqs[:slots]:
        eng.submit(dataclasses.replace(r, tokens=r.tokens[:128],
                                       max_new_tokens=64))
    eng._admit_all()
    tok = eng.state.next_tok
    transformer.decode_step(cfg, params, eng.cache, tok)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        transformer.decode_step(cfg, params, eng.cache, tok)
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    if weights is None:
        weights = _bytes(params)
    states = _state_bytes(cfg, slots, max_len)
    del eng
    _free_card()
    return {"profile_decode_step": device_busy(prof, wall_us),
            "decode_bound_ms": (weights + 2 * states) / HBM_BYTES_PER_S * 1e3,
            "weight_bytes": weights, "state_bytes": states}


def _held_where_determined(name: str, got, want, want64, tol: float
                           ) -> dict:
    """Rows (the first axis) of ``got`` held within ``tol`` of ``want``
    and of ``want64`` where float32 determines them: row 0 always, other
    rows where ``want`` (a float32 run) lies within DETERMINED_SHARE x
    ``tol`` of ``want64`` (the float64 run); the other rows recorded."""
    got, want, want64 = (t.detach().double().cpu() for t in
                         (got, want, want64))
    rows = got.shape[0]
    e64 = (want - want64).reshape(rows, -1).abs().amax(1)
    held = [t for t in range(rows)
            if t == 0 or e64[t] <= DETERMINED_SHARE * tol]
    free = [t for t in range(rows) if t not in held]
    err = max(float((got[held] - want[held]).abs().max()),
              float((got[held] - want64[held]).abs().max()))
    if not err <= tol:
        fail(f"{name}: {err:.3g} from the float32 and float64 runs where "
             f"float32 determines the result, over {tol:.3g}")
    return {"held_rows": len(held), "rows": rows, "max_abs_err_held": err,
            "max_abs_err_free": float((got[free] - want[free]).abs().max())
            if free else 0.0,
            "max_float32_vs_float64_free": float(e64[free].max())
            if free else 0.0}


def _mixer_layer_vs_cpu(cfg, params, layer: int, device) -> dict:
    """Layer ``layer``'s mixer at full width on a seeded input of
    SSM_LAYER_TOKENS tokens, on the card and on the CPU: the largest
    difference within SSM_LAYER_RTOL of the largest |y|.  The mLSTM, whose
    float32 output the arithmetic does not determine at most positions,
    is held position by position where it does (``_held_where_determined``
    against its float64 run on the CPU)."""
    from repro_torch.models import ssm
    plan = transformer.layer_plan(cfg)[layer]
    kind = plan.mixer
    spec = getattr(plan, kind)
    fwd = getattr(ssm, f"{kind}_forward")
    lp = params["layers"][layer][kind]
    n = SSM_LAYER_TOKENS[kind]
    gen = torch.Generator(device=device).manual_seed(SSM_SEED)
    x = torch.randn(1, n, cfg.d_model, generator=gen, device=device)
    _sync(device)
    t0 = time.perf_counter()
    y = fwd(lp, spec, x)
    _sync(device)
    card_s = time.perf_counter() - t0
    cpu_p = {k: v.cpu() for k, v in lp.items()}
    t0 = time.perf_counter()
    yc = fwd(cpu_p, spec, x.cpu())
    cpu_s = time.perf_counter() - t0
    y = y.cpu()
    err = float((y - yc).abs().max())
    scale = float(yc.abs().max())
    out = {"mixer": kind, "layer": layer, "tokens": n, "max_abs_err": err,
           "max_abs_y": scale, "card_s": card_s, "cpu_s": cpu_s}
    if kind == "mlstm":
        with pt_common.float64_models():
            y64 = fwd({k: v.double() for k, v in cpu_p.items()}, spec,
                      x.cpu().double())
        out["positions"] = _held_where_determined(
            f"{kind} layer", y[0], yc[0], y64[0], SSM_LAYER_RTOL * scale)
    elif not err <= SSM_LAYER_RTOL * scale:
        fail(f"{kind} layer: card vs CPU max abs err {err:.3g} over "
             f"{SSM_LAYER_RTOL} of the largest |y| {scale:.3g}")
    del cpu_p
    return out


def _prefix_check(cfg, params, reqs, yardstick, max_len: int,
                  device) -> dict:
    """Each prompt's first token prefilled and its next XLSTM_PREFIX - 1
    tokens decoded, teacher-forced, on the kernel path, the plain path and
    the float64 run: the kernel path within LOGIT_TOL's atol of the other
    two where float32 determines the logits (``_held_where_determined``);
    returns the rows held and the largest differences."""
    plain_cfg = cfg.scaled(use_flash=False, use_fused_norm=False)
    out = {"held_rows": 0, "rows": 0, "max_abs_err_held": 0.0,
           "max_abs_err_free": 0.0, "max_float32_vs_float64_free": 0.0}
    for r in reqs:
        toks = torch.as_tensor(r.tokens, device=device)[None]
        head, fed = toks[:, :1], [int(t) for t in r.tokens[1:XLSTM_PREFIX]]
        runs = []
        for c in (cfg, plain_cfg):
            lg, cache = transformer.prefill(c, params, head, max_len=max_len)
            rows = [lg]
            for tok in fed:
                lg, cache = transformer.decode_step(
                    c, params, cache, torch.tensor([tok], dtype=torch.int32,
                                                   device=device))
                rows.append(lg)
            runs.append(torch.stack(rows))
        got = _held_where_determined(f"xlstm prompt {r.uid}", runs[0],
                                     runs[1], yardstick(head, fed),
                                     LOGIT_TOL["atol"])
        out = {k: out[k] + got[k] if k in ("held_rows", "rows")
               else max(out[k], got[k]) for k in out}
    return out


def _ssm_stream(vocab: int, kw: dict) -> serve_stream.StreamConfig:
    return serve_stream.StreamConfig(vocab_size=vocab, arrival="poisson",
                                     rate=STREAM_RATE, seed=SSM_SEED, **kw)


def xlstm_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 25: xlstm-350m at full width and depth, float32, RMSNorm on
    (25 sites a forward: a block norm each, no FFN norm, the final norm;
    the norms inside the blocks stay plain, as in the reference); its
    logits held to the plain path and the float64 run on each prompt's
    first positions where float32 determines them, and recorded on the
    whole prompts (XLSTM_PREFIX); then one mLSTM and one sLSTM layer held
    to the CPU."""
    if cfg is None:
        cfg = configs.get_config("xlstm-350m")
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, SSM_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    reqs = _requests(cfg.vocab_size, XLSTM_PROMPTS, XLSTM_NEW, SSM_SEED)
    result = serve_model(
        "xlstm", cfg, params, reqs, slots=DANUBE_SLOTS,
        max_len=XLSTM_MAX_LEN, chunk=DANUBE_CHUNK, flash_per_prefill=0,
        rms_per_forward=cfg.num_layers + 1,
        stream=_ssm_stream(cfg.vocab_size, XLSTM_STREAM), device=device,
        compare_logits=False)
    result["prefix_logits"] = _prefix_check(
        cfg, params, reqs, _float64_yardstick(cfg, params, XLSTM_MAX_LEN),
        XLSTM_MAX_LEN, device)
    result.update(layers=cfg.num_layers,
                  params=transformer.param_count(params), init_s=init_s)
    result.update(_decode_profile(cfg, params, reqs, DANUBE_SLOTS,
                                  XLSTM_MAX_LEN, device))
    result["layers_vs_cpu"] = [
        _mixer_layer_vs_cpu(cfg, params, i, device) for i in (0, 1)]
    del params
    _free_card()
    print("xlstm_serve " + json.dumps(result), flush=True)
    return result


def jamba_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 26: jamba-1.5-large at full width, 2 layers, float32, flash
    and RMSNorm on: layer 0 attention through flash (1 launch a prefill)
    with a dense swiglu FFN, layer 1 Mamba with the 16-expert top-2 MoE;
    RMSNorm 5 launches a forward; then the Mamba layer held to the CPU."""
    if cfg is None:
        cfg = configs.get_config("jamba-1.5-large-398b").scaled(
            num_layers=JAMBA_LAYERS)
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, SSM_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    reqs = _requests(cfg.vocab_size, JAMBA_PROMPTS, JAMBA_NEW, SSM_SEED)
    flash_layers = sum(p.mixer == "attn" and p.attn.chunk is None
                       for p in transformer.layer_plan(cfg))
    result = serve_model(
        "jamba", cfg, params, reqs, slots=DANUBE_SLOTS,
        max_len=JAMBA_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=flash_layers,
        rms_per_forward=2 * cfg.num_layers + 1,
        stream=_ssm_stream(cfg.vocab_size, JAMBA_STREAM), device=device)
    result.update(layers=cfg.num_layers,
                  params=transformer.param_count(params), init_s=init_s,
                  decode_capacity=moe.capacity(
                      transformer.layer_plan(cfg)[1].moe, DANUBE_SLOTS))
    result.update(_decode_profile(cfg, params, reqs, DANUBE_SLOTS,
                                  JAMBA_MAX_LEN, device))
    result["mamba_layer_vs_cpu"] = _mixer_layer_vs_cpu(cfg, params, 1,
                                                       device)
    del params
    _free_card()
    print("jamba_serve " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phases 27-28: the encoder-decoder and the image prefix at full width:
# whisper-base, llava-next-mistral-7b
# ---------------------------------------------------------------------------

MM_SEED = 0
# whisper-base at full size (6 encoder + 6 decoder layers, d_model 512, 8
# heads, vocab 51,865, 65,536 learned positions; 105 M parameters, 0.42 GB
# float32): 8 requests, each with its own 30 s of stub audio (1500 frames,
# seed = uid), short decoder prompts: the transcription shape
WHISPER_PROMPTS = [4, 32, 64, 96, 128, 160, 192, 224]
WHISPER_NEW = 32
WHISPER_MAX_LEN = 256
WHISPER_STREAM = dict(num_requests=4, prompt_lens=(4, 224), new_low=16,
                      new_high=32)
# whisper's encoder on 1500 frames on the card against the same weights on
# the CPU: float32 products in other orders through 6 layers of a
# LayerNorm'd stream, held within ENCODER_RTOL of the output's largest
# magnitude
ENCODER_RTOL = 1e-4
# llava-next-mistral-7b at full width (d_model 4096, 32 / 8 heads, d_ff
# 14,336, vocab 32,000, a tied head) cut from 32 to 16 layers (3.63 B
# parameters, 14.5 GB float32; at full depth, 7.13 B and 28.5 GB, the
# phase took 64.8 s and the whole script 1097 s, too near its 1200 s
# limit): 8 requests, each with its own 1152-token stub image prefix (2
# anyres tiles of 576 patches, seed = uid); max_len holds the prefix, the
# longest prompt and the new tokens
LLAVA_LAYERS = 16
LLAVA_PROMPTS = [64, 128, 256, 512, 768, 1024, 1536, 2048]
LLAVA_NEW = 32
LLAVA_MAX_LEN = 4096
LLAVA_STREAM = dict(num_requests=4, prompt_lens=(64, 2048), new_low=16,
                    new_high=32)
# llava's layer 0 at full width on the image prefix and 128 prompt tokens
# (1280 positions), through the kernels on the card against the same layer
# on the CPU, within LLAVA_LAYER_RTOL of the output's largest magnitude
LLAVA_LAYER_TOKENS = 128
LLAVA_LAYER_RTOL = 1e-4
# stream requests take their image or audio from seeds past the requests'
MM_STREAM_SEED = 1000


def _mm_inputs(cfg, seed: int) -> dict:
    """One request's stub input, without the batch axis
    (``models.multimodal``): 1500 frames of audio or the 1152-token image
    prefix, from ``seed``."""
    if cfg.frontend == "vision_stub":
        return {"image_embeds": multimodal.fake_image_patches(
            1, cfg.d_model, cfg.image_tokens, seed=seed)[0]}
    return {"audio_frames": multimodal.fake_audio_frames(
        1, cfg.d_model, cfg.encoder_seq, seed=seed)[0]}


def _mm_requests(cfg, prompts, new: int) -> list:
    return [dataclasses.replace(r, **_mm_inputs(cfg, r.uid))
            for r in _requests(cfg.vocab_size, prompts, new, MM_SEED)]


def _mm_stream(cfg, kw: dict):
    """(stream config, stream_modality) for serve_model."""
    sc = serve_stream.StreamConfig(vocab_size=cfg.vocab_size,
                                   arrival="poisson", rate=STREAM_RATE,
                                   seed=MM_SEED, **kw)
    return sc, lambda uid: _mm_inputs(cfg, MM_STREAM_SEED + uid)


def _held_to_cpu_rel(name: str, y, yc, rtol: float) -> dict:
    err = float((y.cpu() - yc).abs().max())
    scale = float(yc.abs().max())
    if not err <= rtol * scale:
        fail(f"{name}: card vs CPU max abs err {err:.3g} over {rtol} of the "
             f"largest |y| {scale:.3g}")
    return {"max_abs_err": err, "max_abs_y": scale}


def _encoder_vs_cpu(cfg, params, req, device) -> dict:
    """whisper's encoder on one request's 1500 frames: ms an encode on the
    card, and its output held to the same weights' run on the CPU."""
    frames = torch.as_tensor(req.audio_frames, device=device)[None]
    out = {"frames": int(frames.shape[1])}
    if device != "cpu":
        out["encode_ms"] = time_ms(
            lambda: transformer._encode(cfg, params, frames), iters=5,
            samples=3)
    y = transformer._encode(cfg, params, frames)
    cpu_p = {"encoder": pytree.tree_map(lambda t: t.cpu(),
                                        params["encoder"])}
    t0 = time.perf_counter()
    yc = transformer._encode(cfg, cpu_p, frames.cpu())
    out["cpu_s"] = time.perf_counter() - t0
    out.update(_held_to_cpu_rel("whisper encoder", y, yc, ENCODER_RTOL))
    return out


def _conditioned_decode(cfg, params, req, slots: int, max_len: int) -> dict:
    """Two requests with ``req``'s tokens, one with its audio and one with
    the next request's, through the engine decode to different tokens: the
    decoder reads its encoder (the card twin of the reference's
    test_whisper_conditioned_decode)."""
    eng = ResidentEngine(cfg, params, max_slots=slots, max_len=max_len,
                         chunk=DANUBE_CHUNK)
    for uid in (0, 1):
        eng.submit(dataclasses.replace(req, uid=uid,
                                       **_mm_inputs(cfg, req.uid + uid)))
    outs = eng.run_until_done()
    differ = int((outs[0] != outs[1]).sum())
    if differ == 0:
        fail("whisper: two audios decode to the same tokens: the decoder "
             "ignores its encoder")
    return {"tokens": len(outs[0]), "positions_that_differ": differ}


def _decoder_bytes(params) -> int:
    """What a whisper decode step reads of the weights: the decoder layers,
    the tied head (the embedding) and the final norm; not the encoder, nor
    the 65,536 learned positions (one row a step)."""
    return _bytes({k: params[k] for k in ("layers", "embed", "final_norm")})


def whisper_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 27: whisper-base at full size, float32, flash on (the
    decoder's causal self-attention, 6 launches a prefill; the encoder's
    bidirectional layers and the cross-attention take the plain path by
    the reference's rule; LayerNorm, so no RMSNorm launch); each request
    with its own audio; then the encoder held to the CPU and the decoder
    shown to read it."""
    if cfg is None:
        cfg = configs.get_config("whisper-base")
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, MM_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    reqs = _mm_requests(cfg, WHISPER_PROMPTS, WHISPER_NEW)
    stream, modality = _mm_stream(cfg, WHISPER_STREAM)
    result = serve_model(
        "whisper", cfg, params, reqs, slots=DANUBE_SLOTS,
        max_len=WHISPER_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=cfg.num_layers, rms_per_forward=0, stream=stream,
        stream_modality=modality, device=device)
    result.update(layers=cfg.num_layers, encoder_layers=cfg.encoder_layers,
                  params=transformer.param_count(params), init_s=init_s)
    result["encoder_vs_cpu"] = _encoder_vs_cpu(cfg, params, reqs[0], device)
    result["conditioned_decode"] = _conditioned_decode(
        cfg, params, reqs[0], DANUBE_SLOTS, WHISPER_MAX_LEN)
    result.update(_decode_profile(cfg, params, reqs, DANUBE_SLOTS,
                                  WHISPER_MAX_LEN, device,
                                  weights=_decoder_bytes(params)))
    del params
    _free_card()
    print("whisper_serve " + json.dumps(result), flush=True)
    return result


def _llava_layer_vs_cpu(cfg, params, req, device) -> dict:
    """Layer 0 at full width on ``req``'s image prefix and first
    LLAVA_LAYER_TOKENS tokens, through the kernels on the card and on the
    CPU (where the wrappers run their plain versions)."""
    toks = torch.as_tensor(req.tokens[:LLAVA_LAYER_TOKENS], device=device)
    img = torch.as_tensor(req.image_embeds, device=device)
    x, prefix = transformer._embed_inputs(cfg, params, toks[None], img[None])
    plan = transformer.layer_plan(cfg)[0]
    lp = params["layers"][0]
    _sync(device)
    t0 = time.perf_counter()
    y, _ = transformer._block_forward(cfg, plan, lp, x)
    _sync(device)
    card_s = time.perf_counter() - t0
    cpu_p = pytree.tree_map(lambda t: t.cpu(), lp)
    t0 = time.perf_counter()
    yc, _ = transformer._block_forward(cfg, plan, cpu_p, x.cpu())
    cpu_s = time.perf_counter() - t0
    out = {"positions": int(x.shape[1]), "prefix": prefix,
           "card_s": card_s, "cpu_s": cpu_s}
    out.update(_held_to_cpu_rel("llava layer 0", y, yc, LLAVA_LAYER_RTOL))
    return out


def llava_phase(device=SERVE_DEVICE, cfg=None) -> dict:
    """Phase 28: llava-next-mistral-7b at full width, LLAVA_LAYERS deep,
    float32, flash and RMSNorm on: flash once a layer a prefill over
    the image prefix and the prompt, RMSNorm 2 a layer and the final norm a
    forward; each request with its own image prefix; then layer 0 held to
    the CPU."""
    if cfg is None:
        cfg = configs.get_config("llava-next-mistral-7b").scaled(
            num_layers=LLAVA_LAYERS)
    cfg = cfg.scaled(use_flash=True, use_fused_norm=True)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, MM_SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    reqs = _mm_requests(cfg, LLAVA_PROMPTS, LLAVA_NEW)
    stream, modality = _mm_stream(cfg, LLAVA_STREAM)
    result = serve_model(
        "llava", cfg, params, reqs, slots=DANUBE_SLOTS,
        max_len=LLAVA_MAX_LEN, chunk=DANUBE_CHUNK,
        flash_per_prefill=cfg.num_layers,
        rms_per_forward=2 * cfg.num_layers + 1, stream=stream,
        stream_modality=modality, device=device)
    result.update(layers=cfg.num_layers, image_tokens=cfg.image_tokens,
                  params=transformer.param_count(params), init_s=init_s)
    result.update(_decode_profile(cfg, params, reqs, DANUBE_SLOTS,
                                  LLAVA_MAX_LEN, device))
    result["weights_bound_ms"] = \
        result["weight_bytes"] / HBM_BYTES_PER_S * 1e3
    result["layer0_vs_cpu"] = _llava_layer_vs_cpu(
        cfg, params, next(r for r in reqs
                          if len(r.tokens) >= LLAVA_LAYER_TOKENS), device)
    del params
    _free_card()
    print("llava_serve " + json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 29: the launch tools (analytic, roofline, trace inspection) on
# h2o-danube-1.8b's steps, the last two examples and the serving bench
# ---------------------------------------------------------------------------

ROOFLINE_CONTEXT = 6144      # the prefill's tokens and the decode's context
ROOFLINE_SLOTS = 4
ROOFLINE_TIMED = 5           # timed calls a step after one warm-up; median
# a step cannot beat the card's own peak: a share over this means a wrong
# count (5% for the host clock's error on a short step)
ROOFLINE_MAX_SHARE = 1.05
TRACE_DIR = os.path.join(ROOT, "build", "phase29")


def _timed_step(fn) -> list:
    """Host-clock ms of ``ROOFLINE_TIMED`` calls of ``fn`` after one
    warm-up, the card synchronized around each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROOFLINE_TIMED):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _roofline_line(cfg, hw, shape, times, card) -> dict:
    afl = launch_analytic.step_flops(cfg, shape)
    aby = launch_analytic.step_bytes(cfg, shape, 1, dtype_bytes=4)
    mfl = launch_roofline.model_flops(
        cfg, shape, launch_analytic.active_param_count(cfg))
    r = launch_roofline.roofline_terms(
        "h2o-danube-1.8b", shape.name, "h100x1", 0.0, 0.0, None, hw, mfl,
        afl, aby, dtype="float32")
    measured = statistics.median(times)
    row = {"step": shape.kind, "shape": shape.name,
           "tokens": shape.seq_len, "batch": shape.global_batch,
           "analytic_gflop": r.analytic_gflops,
           "analytic_gb": r.analytic_gbytes,
           "t_compute_ms": r.t_compute * 1e3, "t_memory_ms": r.t_memory * 1e3,
           "bottleneck": r.bottleneck, "measured_ms": measured,
           "measured_ms_each": times,
           "share": max(r.t_compute, r.t_memory) * 1e3 / measured,
           "card": card}
    print("launch_roofline " + json.dumps(row), flush=True)
    print(launch_roofline.format_report(r), flush=True)
    return row


def _traced_steps(cfg, params, toks, cache, nxt) -> dict:
    """One prefill and one decode step of the roofline's, traced; the
    trace exported under ``build/phase29/`` and read by ``inspect_trace``,
    whose kernel counts must equal the wrappers' launch counts of the same
    calls (a decode step launches no flash kernel: its attention is the
    plain path's).  The profiler records a warm-up cycle of the same
    steps first and keeps the second: a trace's first kernels can be
    lost while the device tracing starts (one run lost 12 of 2937)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, "danube_steps.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        for _ in range(2):
            fa_ops.launches = rn_ops.launches = 0
            with record_function("launch_tools.prefill"):
                transformer.prefill(cfg, params, toks, max_len=toks.shape[1])
            with record_function("launch_tools.decode"):
                transformer.decode_step(cfg, params, cache, nxt)
            torch.cuda.synchronize()
            prof.step()
    launches = {"flash_attention": fa_ops.launches,
                "rmsnorm": rn_ops.launches}
    res = inspect_trace.analyze(path, top=15)
    print(inspect_trace.format_analysis(res), flush=True)
    if res["source"] != "kernels":
        fail("launch_tools: the trace holds no device kernel")
    counted = {}
    for name, tag in (("flash_attention", "flash_fwd"),
                      ("rmsnorm", "rmsnorm")):
        rows = [r for r in res["all_kernels"] if tag in r["name"]]
        counted[name] = sum(r["count"] for r in rows)
        if not any(tag in r["name"] for r in res["kernels"]):
            fail(f"launch_tools: the trace's top {len(res['kernels'])} "
                 f"kernels do not name the port's {name} kernel")
    if counted != launches:
        fail(f"launch_tools: the trace counts {counted} kernel launches, "
             f"the wrappers {launches}")
    want = {"flash_attention": cfg.num_layers,
            "rmsnorm": 2 * (2 * cfg.num_layers + 1)}
    if launches != want:
        fail(f"launch_tools: {launches} launches in one prefill and one "
             f"decode step, want {want}")
    return {"trace": os.path.relpath(path, ROOT),
            "trace_bytes": os.path.getsize(path), "launches": launches,
            "trace_counts": counted,
            "top": [{k: r[k] for k in ("name", "scope", "count", "total_us",
                                       "mean_us")}
                    for r in res["kernels"][:6]]}


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    """(stdout text, result) of ``fn``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


def _logreg_example() -> dict:
    """examples/torch_decentralized_logreg.py on the card against the same
    code on the CPU: every run's histories (objective and consensus at the
    card-vs-CPU tolerances, steps and gossip rounds exact), the printed
    lines' text; fused_step launches once a step (kernel="auto")."""
    ex = _load_example("torch_decentralized_logreg")
    ops.launches = 0
    t0 = time.perf_counter()
    text, card_runs = _quiet(ex.main, ["--device", "cuda"])
    card_s = time.perf_counter() - t0
    launches = ops.launches
    t0 = time.perf_counter()
    cpu_text, cpu_runs = _quiet(ex.main, ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    steps, worst = 0, 0.0
    for key, hists in card_runs.items():
        for got, want in zip(hists, cpu_runs[key]):
            np.testing.assert_array_equal(got.steps, want.steps)
            np.testing.assert_array_equal(got.comm_rounds, want.comm_rounds)
            np.testing.assert_allclose(
                got.objective, want.objective, rtol=HISTORY_RTOL,
                atol=HISTORY_ATOL, err_msg=f"logreg example {key}")
            np.testing.assert_allclose(
                got.consensus, want.consensus, rtol=SWEEP_CONS_TOL["rtol"],
                atol=SWEEP_CONS_TOL["atol"], err_msg=f"logreg example {key}")
            worst = max(worst, float(np.max(np.abs(got.objective
                                                   - want.objective))))
            steps += int(got.steps[-1])
    strip = lambda t: [ln.split(":")[0] for ln in t.splitlines()]
    if strip(text) != strip(cpu_text) or len(text.splitlines()) != 11:
        fail(f"logreg example: printed\n{text}\nagainst the CPU's\n"
             f"{cpu_text}")
    if launches != steps:
        fail(f"logreg example: {launches} fused_step launches for {steps} "
             f"steps")
    print(text, end="", flush=True)
    return {"runs": 2 * len(card_runs), "steps": steps,
            "launches": {"fused_step": launches},
            "max_abs_objective_vs_cpu": worst, "card_s": card_s,
            "cpu_s": cpu_s}


def _batching_example() -> dict:
    """examples/torch_continuous_batching.py on the card against the CPU
    on the same seed-0 weights (made on the CPU): every uid's tokens
    equal, flash and RMSNorm launched on the card."""
    ex = _load_example("torch_continuous_batching")
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b"))
    cpu_params = transformer.init_params(cfg, 0, "cpu")
    card_params = pytree.tree_map(lambda t: t.to(SERVE_DEVICE), cpu_params)
    fa_ops.launches = rn_ops.launches = 0
    t0 = time.perf_counter()
    text, outs = _quiet(ex.main, ["--device", "cuda"], params=card_params)
    card_s = time.perf_counter() - t0
    launches = {"flash_attention": fa_ops.launches,
                "rmsnorm": rn_ops.launches}
    _, cpu_outs = _quiet(ex.main, ["--device", "cpu"], params=cpu_params)
    if sorted(outs) != list(range(7)) or any(
            not np.array_equal(outs[u], cpu_outs[u]) for u in outs):
        fail(f"batching example: card tokens {outs} against the CPU's "
             f"{cpu_outs}")
    # one flash launch a layer a prefill (7 requests); RMSNorm 2L + 1 a
    # forward (prefills and decode steps)
    rms_each = 2 * cfg.num_layers + 1
    if launches["flash_attention"] != 7 * cfg.num_layers or \
            launches["rmsnorm"] % rms_each or \
            launches["rmsnorm"] <= 7 * rms_each:
        fail(f"batching example: launches {launches}")
    print(text, end="", flush=True)
    return {"requests": len(outs), "tokens": sum(len(v)
                                                 for v in outs.values()),
            "launches": launches, "card_s": card_s}


def _serve_bench() -> dict:
    """benchmarks/pt_serve_bench.py on the card (its own asserts: host and
    engine tokens equal, the ledger O(1) a chunk), RMSNorm and flash
    launched by its smoke rows."""
    fa_ops.launches = rn_ops.launches = 0
    t0 = time.perf_counter()
    text, ss = _quiet(pt_serve_bench.main, ["--device", "cuda"])
    launches = {"flash_attention": fa_ops.launches,
                "rmsnorm": rn_ops.launches}
    if not ss["outputs_equal"] or not all(launches.values()):
        fail(f"pt_serve_bench: outputs_equal {ss['outputs_equal']}, "
             f"launches {launches}")
    print(text, end="", flush=True)
    return {"host_ms_per_token": ss["host_ms_per_token"],
            "resident_ms_per_token": ss["resident_ms_per_token"],
            "speedup_resident_vs_host": ss["speedup_resident_vs_host"],
            "ttft_ms": ss["ttft_ms"], "tpot_ms": ss["tpot_ms"],
            "transfers": ss["transfers"],
            "prefill_decode": ss["prefill_decode"], "launches": launches,
            "s": time.perf_counter() - t0}


@torch.no_grad()
def launch_tools_phase(cfg, params, card: str) -> dict:
    """Phase 29.  (a) h2o-danube-1.8b's steps at full width (phase 11's
    weights, float32, the kernel path) read against the roofline at the
    card's rates (``HW.from_device``); (b) one prefill and one decode step
    traced and read by ``inspect_trace``; (c) both examples and the
    serving bench on the card."""
    t_phase = time.perf_counter()
    hw = launch_roofline.HW.from_device(0)
    rng = np.random.default_rng(DANUBE_SEED)
    n = ROOFLINE_CONTEXT
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, n))
                           .astype(np.int32), device=SERVE_DEVICE)
    fa_ops.launches = rn_ops.launches = 0
    prefill_times = _timed_step(
        lambda: transformer.prefill(cfg, params, toks, max_len=n))
    prefill_launches = {"flash_attention": fa_ops.launches,
                        "rmsnorm": rn_ops.launches}
    # a 4-slot cache at context 6144: one batched prefill of 4 prompts.
    # Each timed decode step decodes position 6144 from the same cache
    # (decode_step returns the advanced positions in a new dict and writes
    # its K and V in place, at the same slot each time)
    slots = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, size=(ROOFLINE_SLOTS, n)).astype(np.int32),
        device=SERVE_DEVICE)
    logits, cache = transformer.prefill(cfg, params, slots, max_len=n + 1)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)

    def decode():
        return transformer.decode_step(cfg, params, cache, nxt)

    fa_ops.launches = rn_ops.launches = 0
    decode_times = _timed_step(decode)
    decode_launches = {"flash_attention": fa_ops.launches,
                       "rmsnorm": rn_ops.launches}
    dl, _ = decode()
    if not bool(torch.isfinite(dl).all()) or \
            tuple(dl.shape) != (ROOFLINE_SLOTS, cfg.vocab_size):
        fail(f"launch_tools: decode logits of shape {tuple(dl.shape)}, "
             f"not all finite")
    calls = ROOFLINE_TIMED + 1
    if prefill_launches != {"flash_attention": calls * cfg.num_layers,
                            "rmsnorm": calls * (2 * cfg.num_layers + 1)} or \
            decode_launches != {"flash_attention": 0, "rmsnorm": calls * (
                2 * cfg.num_layers + 1)}:
        fail(f"launch_tools: launches {prefill_launches} (prefills), "
             f"{decode_launches} (decode steps)")
    rows = {}
    for kind, times, batch, bound_by in (
            ("prefill", prefill_times, 1, "compute"),
            ("decode", decode_times, ROOFLINE_SLOTS, "memory")):
        shape = configs.InputShape(f"{kind}_{n}", n, batch, kind)
        rows[kind] = row = _roofline_line(cfg, hw, shape, times, card)
        if row["bottleneck"] != bound_by:
            fail(f"launch_tools: the {kind} is bound by {row['bottleneck']}"
                 f", want {bound_by}")
        if row["share"] > ROOFLINE_MAX_SHARE:
            fail(f"launch_tools: the {kind} reads {row['share']:.3f} of the "
                 f"card's bound: a wrong count")
    t_a = time.perf_counter() - t_phase

    trace = _traced_steps(cfg, params, toks, cache, nxt)
    del cache, logits, dl
    _free_card()
    t_b = time.perf_counter() - t_phase - t_a

    result = {"roofline": rows, "launches_prefill": prefill_launches,
              "launches_decode": decode_launches, "trace": trace,
              "logreg_example": _logreg_example(),
              "batching_example": _batching_example(),
              "serve_bench": _serve_bench(),
              "card": card, "a_s": t_a, "b_s": t_b}
    result["phase_s"] = time.perf_counter() - t_phase
    print("launch_tools " + json.dumps(result), flush=True)
    return result


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    device = "cuda"
    t_start = time.perf_counter()

    def elapsed(label: str) -> None:
        print(f"elapsed after {label}: {time.perf_counter() - t_start:.1f} s",
              flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # phase 2: build every kernel, one nvcc each, all started together.  The
    # flash library takes the longest by far: phases 3-8 launch none of its
    # kernels, so they run while it builds, and phase 9 waits for it
    t_build = time.perf_counter()
    late = [s for s in SOURCES if s == fa_kernel.SOURCE]
    late_build = _build.start(late)
    _BACKGROUND.append(late_build)
    print_build(_build.build([s for s in SOURCES if s not in late]),
                [s for s in SOURCES if s not in late], t_build)
    print(f"fused_step max m {kernel.max_m()}", flush=True)

    # phase 3: kernel vs plain version
    rows = check_kernel(device)
    max_err = max(r["max_abs_err"] for r in rows.values())
    print(f"kernel: all {len(rows)} cases within rtol {KERNEL_RTOL} / atol "
          f"{KERNEL_ATOL} of the plain version (max abs err {max_err:.3g})",
          flush=True)

    elapsed("phase 3")

    # phase 4: svrg_step and mix_prox vs their plain versions
    t0 = time.perf_counter()
    svrg_mix_err, svrg_mix_rows = check_svrg_mix(device)
    print(f"phase 4 (svrg_step, mix_prox): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 5: the auto threshold's measurements
    time_auto(device)

    elapsed("phase 5")

    # phase 6: the main path at full width
    cfg = paper_logreg.CONFIG
    t0 = time.perf_counter()
    ds = synthetic.make_paper_dataset("cifar10_like", scale=1.0, seed=0)
    parts = synthetic.partition_per_node(ds, cfg.num_nodes)
    print(f"data: cifar10_like n={ds.n} d={ds.dim} m={cfg.num_nodes} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ops.launches = 0
    gpu = main_path_runs(device, parts, ds.dim, "fused")
    main_launches = ops.launches
    cpu = main_path_runs("cpu", parts, ds.dim, "fused")
    # the same runs through the eager executor on the card
    runner.CUDA_GRAPHS = False
    eager = main_path_runs(device, parts, ds.dim, "fused")
    runner.CUDA_GRAPHS = True
    for (name, res, steps, launches, secs, most), (_, cres, _, _, csecs, _), \
            (_, eres, _, elaunches, esecs, _) in zip(gpu, cpu, eager):
        if launches != steps or elaunches != steps:
            fail(f"{name}: {launches} kernel launches (eager {elaunches}) "
                 f"for {steps} steps")
        check_history(name, res)
        check_graphs(name, res.extras, most)
        if eres.extras["replays"] != 0:
            fail(f"{name}: the eager executor replayed graphs")
        ledger = (res.extras["transfers_h2d"], res.extras["transfers_d2h"])
        if ledger != (1, 1):
            fail(f"{name}: transfer ledger {ledger}, want (1, 1)")
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(cres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name} {col}: card vs CPU")
        graph_vs_eager = 0.0
        for got, want in ((res.history.objective, eres.history.objective),
                          (res.history.consensus, eres.history.consensus),
                          (res.params.cpu().numpy(),
                           eres.params.cpu().numpy())):
            graph_vs_eager = max(graph_vs_eager,
                                 float(np.max(np.abs(got - want))))
        print(f"{name}: max_abs_graph_vs_eager {graph_vs_eager}", flush=True)
        for col in ("objective", "consensus"):
            np.testing.assert_allclose(
                getattr(res.history, col), getattr(eres.history, col),
                rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                err_msg=f"{name} {col}: graphs vs eager on the card")
        np.testing.assert_array_equal(res.history.steps, cres.history.steps)
        print("main_path " + json.dumps({
            "algorithm": name, "steps": steps, "launches": launches,
            "records": len(res.history.objective),
            "objective_first": float(res.history.objective[0]),
            "objective_last": float(res.history.objective[-1]),
            "consensus_last": float(res.history.consensus[-1]),
            "max_abs_objective_vs_cpu": float(np.max(np.abs(
                res.history.objective - cres.history.objective))),
            "max_abs_graph_vs_eager": graph_vs_eager,
            "run_s": secs, "ms_per_step": secs / steps * 1e3,
            "cpu_run_s": csecs,
            "eager_run_s": esecs, "eager_ms_per_step": esecs / steps * 1e3,
            "graphs_built": res.extras["graphs_built"],
            "max_graphs": most, "replays": res.extras["replays"],
            "capture_s": res.extras["capture_s"],
            "transfers_h2d": res.extras["transfers_h2d"],
            "transfers_d2h": res.extras["transfers_d2h"]}), flush=True)

    # phase 7: where the card's time goes on the main path
    print("profile " + json.dumps(profile_main_path(parts, ds.dim)),
          flush=True)

    elapsed("phase 7")

    # phase 8: the kernel bench at full width, DVR banded, DSPG via "auto"
    t0 = time.perf_counter()
    bench = kernel_bench_phase()
    print("profile_large_d " + json.dumps(profile_large_d()), flush=True)
    dvr_and_auto_phase()
    print(f"phase 8 (kernel bench, dvr, auto): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 9: RMSNorm and flash attention against their plain versions,
    # once the flash library started in phase 2 is built
    t0 = time.perf_counter()
    print_build(late_build.wait(), late, t_build)
    print(f"build: waited {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(s.name for s in late)}", flush=True)
    sass = flash_sass()
    print("flash_sass " + json.dumps(sass), flush=True)
    if sass["cuobjdump"] is not None and sass["hgmma"] == 0:
        fail("the flash library holds no HGMMA instruction: the bf16 "
             "kernel does not run on the tensor cores")
    rms_rows = check_rmsnorm(device)
    flash_rows = check_flash(device)
    rms_err = max(r["max_abs_err"] for r in rms_rows.values()
                  if r["dtype"] == "float32")
    flash_err = max(r["max_abs_err"] for r in flash_rows.values()
                    if r["dtype"] == "float32")
    flash_over = max(r["max_err_over_bound"] for r in flash_rows.values()
                     if r["dtype"] == "bfloat16")
    print(f"rmsnorm: all {len(rms_rows)} cases within tolerance of the "
          f"plain version (float32 max abs err {rms_err:.3g}); flash: all "
          f"{len(flash_rows)} cases (float32 max abs err {flash_err:.3g}, "
          f"bf16 at most {flash_over:.3g} of its bound)", flush=True)

    elapsed("phase 9")

    # phase 10: h2o-danube-1.8b in bf16 through the bf16 flash kernel
    bf16_prefill = danube_bf16_prefill()

    elapsed("phase 10")

    # phases 11-12: serve h2o-danube-1.8b at full width, then a stream
    danube_cfg, danube_params = danube_weights()
    serve = serve_danube(danube_cfg, danube_params)

    elapsed("phase 12")

    # phase 29: the launch tools on phase 11's weights (run here so that
    # the 7 GB are not held through phases 13-28), the examples and the
    # serving bench
    launch = launch_tools_phase(danube_cfg, danube_params, card)
    del danube_params
    _free_card()

    elapsed("phase 29")

    # phase 13: the launcher at its smoke size
    summary = launch_serve.main(["--arch", "h2o-danube-1.8b", "--stream"])
    if summary["requests"] != 16:
        fail(f"launch.serve: {summary['requests']} requests finished")

    elapsed("phase 13")

    # phase 14: fused_step over a sweep's cells against single launches
    t0 = time.perf_counter()
    cells_kernel = check_cells_kernel(device)
    print(f"phase 14 (fused_step over cells): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 15: the paper's figures as batched sweeps at full scale
    t0 = time.perf_counter()
    figures = paper_figures_phase(device)
    print(f"phase 15 (paper figures): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 16: train danube at full width (4 layers), resume, serve the
    # consensus of the checkpoint through the kernels
    t0 = time.perf_counter()
    train = train_phase(card)
    print(f"phase 16 (train, resume, serve the consensus): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 17: network-event scenarios through the batched sweeps
    t0 = time.perf_counter()
    scen = scenario_phase(device)
    print(f"phase 17 (scenarios): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phase 19: the execution modes on the card (device sampling, scan,
    # device-sampled sweeps, train_sweep, device-sampled training)
    t0 = time.perf_counter()
    modes = exec_modes_phase(parts, ds.dim, device)
    print(f"phase 19 (exec modes): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phases 21-23: stablelm-12b, llama4-scout and llama4-maverick served at
    # full width; phase 24: MoE training at smoke size
    served = {}
    for name, phase in (("stablelm", stablelm_phase), ("scout", scout_phase),
                        ("maverick", maverick_phase)):
        t0 = time.perf_counter()
        served[name] = phase()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{served[name]['peak_bytes'] / 1e9:.1f} GB ({card})",
              flush=True)
    t0 = time.perf_counter()
    moe_train_phase(device)
    xlstm_train_phase(device)
    print(f"phase 24 (moe and xlstm train): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # phases 25-26: xlstm-350m at full size and jamba-1.5-large at full
    # width (2 layers) served; phases 27-28: whisper-base at full size and
    # llava-next-mistral-7b at full width (16 layers) served with their
    # audio and image prefixes
    for name, phase in (("xlstm", xlstm_phase), ("jamba", jamba_phase),
                        ("whisper", whisper_phase), ("llava", llava_phase)):
        t0 = time.perf_counter()
        served[name] = phase()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{served[name]['peak_bytes'] / 1e9:.1f} GB ({card})",
              flush=True)

    elapsed("phase 28")

    main_row = rows[(8, 1024, "svrg", "l1")]
    # the shape the kernel bench gives svrg_step and mix_prox
    svrg_row = svrg_mix_rows[("svrg_step", pt_kernel_bench.ROWS)]
    mix_row = svrg_mix_rows[("mix_prox", pt_kernel_bench.ROWS)]
    rms_row = rms_rows[RMS_LINE_SHAPE + ("float32",)]
    flash_row = flash_rows[(DANUBE_FLASH_CASE, "float32")]
    flash_bf16_row = flash_rows[(DANUBE_FLASH_CASE, "bfloat16")]
    flash_bf16_err = max(r["max_abs_err"] for r in flash_rows.values()
                         if r["dtype"] == "bfloat16")
    # Fig. 5's and Fig. 1's shape on mnist_like: four cells of (8, 784);
    # the error is the bitwise check's against single launches
    cells_row = cells_kernel["rows"][(4, 8, 784)]

    def line(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "share_of_bound": row["bound_ms"] / row["ms"]}

    kernels_line = [
        line("fused_step",
             "src/repro_torch/kernels/fused_update/csrc/fused_step.cu",
             "src/repro/kernels/fused_update/kernel.py:108", main_launches,
             max_err, main_row),
        line("svrg_step",
             "src/repro_torch/kernels/fused_update/csrc/svrg_mix.cu",
             "src/repro/kernels/fused_update/kernel.py:68",
             bench["launches"]["svrg_step"], svrg_mix_err["svrg_step"],
             svrg_row),
        line("mix_prox",
             "src/repro_torch/kernels/fused_update/csrc/svrg_mix.cu",
             "src/repro/kernels/fused_update/kernel.py:75",
             bench["launches"]["mix_prox"], svrg_mix_err["mix_prox"],
             mix_row),
        line("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
             "src/repro/kernels/rmsnorm/kernel.py:37",
             serve["launches"]["rmsnorm"], rms_err, rms_row),
        line("flash_attention",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:106",
             serve["launches"]["flash_attention"], flash_err, flash_row),
        line("flash_attention_bf16",
             "src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:106",
             bf16_prefill["launches"]["flash_attention"], flash_bf16_err,
             flash_bf16_row),
        line("fused_step_cells",
             "src/repro_torch/kernels/fused_update/csrc/fused_step.cu",
             "src/repro/kernels/fused_update/kernel.py:108",
             figures["launches"]["fused_step_cells"],
             cells_row["max_abs_err"], cells_row),
    ]
    # phase 16 serves the trained consensus through RMSNorm and flash too;
    # phase 17 steps its scenario sweep through fused_step's cell-batched
    # launch, and the same cells' sequential runs through the single launch;
    # phase 19 its device-sampled main path through the single launch and
    # its device-sampled Fig. 4 sweeps through the cell-batched one
    for row in kernels_line:
        if row["name"] in train["serve"]["launches"]:
            row["launches_consensus_serve"] = \
                train["serve"]["launches"][row["name"]]
        if row["name"] == "fused_step":
            row["launches_scenarios"] = \
                scen["launches_sequential"]["fused_step"]
        if row["name"] == "fused_step_cells":
            row["launches_scenarios"] = \
                scen["launches"]["fused_step_cells"]
        if row["name"] in modes["launches"]:
            row["launches_exec_modes"] = modes["launches"][row["name"]]
        # phases 21-23 serve stablelm-12b (flash float32), llama4-scout
        # (flash float32 on its global layer, RMSNorm) and llama4-maverick
        # (RMSNorm bf16); phases 25-26 xlstm-350m (RMSNorm) and
        # jamba-1.5-large (flash float32 and RMSNorm); phases 27-28
        # whisper-base (flash float32) and llava-next-mistral-7b (flash
        # float32 and RMSNorm)
        for name, res in served.items():
            if row["name"] in res["launches"]:
                row[f"launches_{name}_serve"] = res["launches"][row["name"]]
        # phase 29: danube's timed prefills and decode steps (RMSNorm and
        # flash float32), the logistic-regression example (fused_step)
        if row["name"] in launch["launches_prefill"]:
            row["launches_launch_tools"] = \
                launch["launches_prefill"][row["name"]] + \
                launch["launches_decode"][row["name"]]
        if row["name"] == "fused_step":
            row["launches_logreg_example"] = \
                launch["logreg_example"]["launches"]["fused_step"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
