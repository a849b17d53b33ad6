"""The resident path's pieces, its on-device minibatch gathers and its CUDA
graph executor, on the CPU.

A chunk runs as power-of-two pieces cut at every outer-round transition
(``runner._pieces``); on the card each piece replays a CUDA graph
(``core.cuda_graphs.PieceGraphs``).  The CPU has no graphs, so the graph
executor is driven here with a stand-in for the capture that keeps what a
capture means: capturing runs no kernel (the state is put back), and a
replay runs no wrapper (the launch counts are put back).  Everything else,
the state buffers, the static inputs copied before each replay, the
warm-up on scratch state and the launch bookkeeping, is the code the card
runs.  Its histories must equal the eager executor's bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from _torch_parity import M, problems
from repro_torch import kernels
from repro_torch.core import algorithm, cuda_graphs, graphs, runner, transport
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.kernels.fused_update import ops

NAMES = ["dpsvrg", "dspg", "loopless_dpsvrg", "dvr", "dpg", "gt_svrg"]


def make(name, problem):
    if name == "dpsvrg":
        return algorithm.dpsvrg_algorithm(problem, algorithm.DPSVRGHyperParams(
            alpha=0.2, beta=1.2, n0=4, num_outer=6))
    if name == "dspg":
        return algorithm.dspg_algorithm(
            problem, algorithm.DSPGHyperParams(alpha0=0.2), 150)
    if name == "loopless_dpsvrg":
        return algorithm.loopless_dpsvrg_algorithm(problem, 0.2, 60,
                                                   snapshot_prob=0.1)
    if name == "dvr":
        return algorithm.dvr_algorithm(problem, 0.2, 60, rho=0.6,
                                       snapshot_prob=0.1)
    if name == "dpg":
        return algorithm.dpg_algorithm(problem, 0.2, 30)
    return algorithm.gt_svrg_algorithm(problem, 0.05, num_outer=3,
                                       inner_steps=10)


def run(name, gossip="dense", record_every=None, **spec):
    _, tp = problems()
    if record_every is None:
        record_every = 0 if name == "dpsvrg" else 10
    return runner.run(make(name, tp), tp,
                      graphs.b_connected_ring_schedule(M, 1),
                      ExecSpec(resident=True, gossip=gossip, device="cpu",
                               **spec), seed=0, record_every=record_every)


def assert_same_run(want, got):
    for field in want.history._fields:
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field),
                                      err_msg=field)
    np.testing.assert_array_equal(got.params.numpy(), want.params.numpy())
    for key in ("wire_bytes", "transfers_h2d", "transfers_d2h"):
        np.testing.assert_array_equal(got.extras[key], want.extras[key])


def _plan(name, record_every, transitions=True):
    _, tp = problems()
    algo = make(name, tp)
    sched = graphs.b_connected_ring_schedule(M, 1)
    backend = transport.resolve_backend("dense", sched, algo.meta)
    n = tp.full_data["labels"].shape[1]
    return runner._plan_resident(
        algo.meta, np.random.default_rng(0), backend,
        backend.prepare(sched, algo.meta), m=M, n=n,
        param_count=int(tp.x0.shape[1]), record_every=record_every,
        transitions=transitions)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def _check_pieces(chunk):
    pieces = runner._pieces(chunk)
    # cover the chunk's steps exactly, in order
    covered = [j for start, length in pieces
               for j in range(start, start + length)]
    assert covered == list(range(chunk.length))
    for start, length in pieces:
        assert length & (length - 1) == 0          # a power of two
        if chunk.flags is not None:
            o_pre, o_post, e_post, _ = chunk.flags
            # o_pre fires only at a piece's first step, o_post / e_post
            # only at its last
            assert not o_pre[start + 1:start + length].any()
            assert not (o_post | e_post)[start:start + length - 1].any()
    return pieces


@pytest.mark.parametrize("cap", [1, 4, 64])
@pytest.mark.parametrize("seed", range(3))
def test_pieces_cover_each_chunk_and_cut_at_every_flag(seed, cap,
                                                       monkeypatch):
    monkeypatch.setattr(runner, "MAX_PIECE", cap)
    rng = np.random.default_rng(seed)
    for _ in range(50):
        length = int(rng.integers(1, 130))
        flags = (rng.random(length) < 0.05, rng.random(length) < 0.05,
                 rng.random(length) < 0.05,
                 np.zeros(length, np.float32))
        chunk = runner._Chunk((None, None, np.zeros(length, np.float32)),
                              flags)
        pieces = _check_pieces(chunk)
        # a flag-free stretch: whole pieces of MAX_PIECE steps, then one
        # piece per set bit of what is left
        free = runner._Chunk(chunk.xs, None)
        cap = runner.MAX_PIECE
        assert len(runner._pieces(free)) == \
            length // cap + bin(length % cap).count("1")
        assert len(pieces) >= len(runner._pieces(free))
        assert max(n for _, n in pieces) <= cap


@pytest.mark.parametrize("name,record_every,transitions", [
    ("dpsvrg", 0, True), ("dpsvrg", 7, True), ("dpsvrg", 0, False),
    ("dspg", 10, True), ("dspg", 50, True), ("loopless_dpsvrg", 10, True),
    ("loopless_dpsvrg", 10, False), ("dvr", 7, True), ("gt_svrg", 7, True)])
def test_a_run_takes_at_most_log2_plus_one_piece_lengths(name, record_every,
                                                        transitions):
    plan = _plan(name, record_every, transitions)
    lengths = set()
    for chunk in plan.chunks:
        lengths.update(length for _, length in _check_pieces(chunk))
    longest = max(chunk.length for chunk in plan.chunks)
    assert len(lengths) <= min(math.ceil(math.log2(longest)),
                               math.log2(runner.MAX_PIECE)) + 1


def test_the_plan_stores_indices_and_no_batch():
    """finish_chunk keeps the (chunk, m, bsz) int indices of the np.random
    draws; the device gathers the same elements a host gather gives."""
    _, tp = problems()
    plan = _plan("dspg", 10)
    host = {k: v.numpy() for k, v in tp.full_data.items()}
    for chunk in plan.chunks:
        idx = chunk.xs[0]
        assert idx.dtype == np.int64 and idx.shape == (chunk.length, M, 1)
        got = runner.gather_batches(tp.full_data, torch.from_numpy(idx))
        for key, a in host.items():
            want = np.take_along_axis(
                a[None], idx.reshape(idx.shape + (1,) * (a.ndim - 2)),
                axis=2)
            np.testing.assert_array_equal(got[key].numpy(), want)


def test_the_resident_plan_draws_the_host_loops_indices():
    """The plan's indices are the host loop's sample_batch draws, in
    order."""
    _, tp = problems()
    plan = _plan("dspg", 10)
    rng = np.random.default_rng(0)
    n = tp.full_data["labels"].shape[1]
    for chunk in plan.chunks:
        for step_idx in chunk.xs[0]:
            np.testing.assert_array_equal(
                step_idx, rng.integers(0, n, size=(M, 1)))


# ---------------------------------------------------------------------------
# the graph executor, with a stand-in for the capture
# ---------------------------------------------------------------------------

class CpuGraphs(cuda_graphs.PieceGraphs):
    """PieceGraphs whose capture is played on the CPU: capturing runs the
    piece and puts the state back (a capture runs no kernel); a replay
    runs it and puts the launch counts back (a replay runs no wrapper)."""

    def _warm_up(self, fn):
        fn()

    def _capture(self, record):
        saved = [None if b is None else b.clone() for b in self._buffers]
        record()
        for b, s in zip(self._buffers, saved):
            if b is not None:
                b.copy_(s)

        def replay():
            counts = kernels.launch_counts()
            record()
            kernels.set_launch_counts(counts)

        return replay


def use_cpu_graphs(monkeypatch) -> list:
    """From here on, resident runs take the graph executor with the CPU
    stand-in; returns the list of the executors made."""
    made = []

    def piece_runner(device, body):
        made.append(CpuGraphs(body))
        return made[-1].run, made[-1]

    monkeypatch.setattr(runner, "_piece_runner", piece_runner)
    return made


@pytest.fixture
def counted_fused(monkeypatch):
    """fused_step_buf counts its calls as a launch, as it does on the
    card."""
    orig = ops.fused_step_buf

    def counted(*args, **kw):
        ops.launches += 1
        return orig(*args, **kw)

    monkeypatch.setattr(ops, "fused_step_buf", counted)
    monkeypatch.setattr(ops, "launches", 0)


CASES = [(name, gossip, transitions) for name in NAMES
         for gossip in ("dense", "banded", "compressed")
         for transitions in ("auto", False)
         # DSPG and DPG thread no mix state: no compressed run
         if not (name in ("dspg", "dpg") and gossip == "compressed")]


@pytest.mark.parametrize("name,gossip,transitions", CASES)
def test_graph_executor_equals_the_eager_executor(name, gossip, transitions,
                                                  monkeypatch,
                                                  counted_fused):
    eager = run(name, gossip, kernel="fused", device_transitions=transitions)
    eager_launches = ops.launches
    made = use_cpu_graphs(monkeypatch)
    got = run(name, gossip, kernel="fused", device_transitions=transitions)
    (pg,) = made
    assert_same_run(eager, got)
    steps = int(got.history.steps[-1])
    # one fused_step a step wherever the fused lowering applies (not under
    # compressed gossip, nor for GT-SVRG, which has no fused twin), counted
    # per replay exactly as the eager run counts them
    fused = gossip != "compressed" and name != "gt_svrg"
    assert ops.launches - eager_launches == eager_launches == \
        (steps if fused else 0)
    assert got.extras["graphs_built"] == pg.graphs_built >= 1
    assert got.extras["replays"] == pg.replays >= pg.graphs_built
    assert eager.extras["graphs_built"] == eager.extras["replays"] == 0
    longest = max(c.length for c in _plan(
        name, 0 if name == "dpsvrg" else 10, transitions is not False
        and name not in ("dspg", "dpg")).chunks)
    assert pg.graphs_built <= math.ceil(math.log2(longest)) + 1


@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg", "dvr"])
def test_pieces_equal_the_per_step_executor(name, monkeypatch):
    """Grouping the steps into pieces changes nothing: the same histories,
    bit for bit, as one-step pieces (the parent's per-step executor)."""
    pieces = run(name, kernel="fused")

    def one_step(chunk):
        return [(j, 1) for j in range(chunk.length)]

    monkeypatch.setattr(runner, "_pieces", one_step)
    assert_same_run(run(name, kernel="fused"), pieces)


@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg"])
def test_graph_executor_with_long_pieces(name, monkeypatch):
    """Pieces up to 64 steps: one graph per power of two of the run's
    chunks, the same run."""
    eager = run(name, kernel="fused")
    monkeypatch.setattr(runner, "MAX_PIECE", 64)
    made = use_cpu_graphs(monkeypatch)
    got = run(name, kernel="fused")
    assert_same_run(eager, got)
    lengths = {n for c in _plan(name, 0 if name == "dpsvrg" else 10).chunks
               for _, n in runner._pieces(c)}
    assert made[0].graphs_built == len(lengths) >= 2


def test_warm_up_and_capture_do_not_advance_the_run(monkeypatch,
                                                   counted_fused):
    """A warm-up or capture that wrote the real state would shift the run:
    the warm-up runs on scratch copies, and both launch counts are taken
    back."""
    eager = run("dspg", kernel="fused")
    made = use_cpu_graphs(monkeypatch)
    got = run("dspg", kernel="fused")
    assert_same_run(eager, got)
    assert ops.launches == 2 * 150
    # chunks of 10 steps: pieces of 4, 4 and 2, two graphs, 45 replays
    assert runner.MAX_PIECE == 4
    assert (made[0].graphs_built, made[0].replays) == (2, 45)


def test_state_buffers_keep_the_callers_tensors_untouched(monkeypatch):
    _, tp = problems()
    x0 = tp.x0.clone()
    use_cpu_graphs(monkeypatch)
    run("dpsvrg", kernel="fused")
    assert torch.equal(tp.x0, x0)


def test_store_clones_a_leaf_that_is_another_overwritten_buffer():
    a, b = torch.tensor([1.0]), torch.tensor([2.0])
    # swap: a <- b, b <- a
    cuda_graphs._store([a, b], [b, a])
    assert (float(a), float(b)) == (2.0, 1.0)
    # pass-through and a None leaf are skipped
    c = torch.tensor([3.0])
    cuda_graphs._store([c, None], [c, None])
    assert float(c) == 3.0


def test_a_state_that_changes_structure_is_refused():
    pg = cuda_graphs.PieceGraphs(lambda s, xs, n: s)
    pg._adopt((torch.zeros(1),))
    with pytest.raises(ValueError, match="structure"):
        pg._adopt((torch.zeros(1), torch.zeros(1)))
