"""The yardstick on known inputs: the request generator repeats for a
seed and gives every seed the same work, the serving summary counts a
miss, the counts of work match hand arithmetic, and the trace reduction
takes a union of intervals."""

from pbcore import env

env.prepare()


import math

import numpy as np
import pytest
import torch

from pbcore import checks
from pbcore.drivers import datasets, lm_common, logreg_grid
from pbcore.frozen import counts, serving
from pbcore.trace import Trace

MIX = {"rate": 10.0,
       "prompt": {"median": 768, "sigma": 0.8, "min": 64, "max": 4096},
       "new_tokens": {"min": 16, "max": 64}}


def test_requests_repeat_for_a_seed_and_differ_across_seeds():
    a = serving.make_requests(MIX, 2**31 + 99, 20.0, 32000)
    b = serving.make_requests(MIX, 2**31 + 99, 20.0, 32000)
    c = serving.make_requests(MIX, 5, 20.0, 32000)
    assert len(a) == 200
    for x, y in zip(a, b):
        assert x.due == y.due and x.max_new_tokens == y.max_new_tokens
        assert np.array_equal(x.tokens, y.tokens)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))


def test_every_seed_gets_the_same_work():
    a = serving.make_requests(MIX, 1, 20.0, 32000)
    b = serving.make_requests(MIX, 2, 20.0, 32000)
    for key in (lambda q: len(q.tokens), lambda q: q.max_new_tokens):
        assert sorted(map(key, a)) == sorted(map(key, b))
        assert list(map(key, a)) != list(map(key, b))
    assert a[-1].due == pytest.approx(b[-1].due)
    assert a[-1].due < 20.0
    lens = [len(q.tokens) for q in a]
    assert min(lens) >= 64 and max(lens) <= 4096
    assert 600 <= float(np.median(lens)) <= 900


@pytest.mark.parametrize("n", [200, 207, 7])
def test_the_order_spreads_each_band(n):
    order = serving.stratified_order(n, 20, np.random.default_rng(3))
    assert sorted(order) == list(range(n))
    nb = -(-n // 20)
    bands = [rank // nb for rank in order]
    for start in range(n):
        window = bands[start:start + 20]
        assert max(window.count(b) for b in window) <= 2
        if n % 20 == 0 and start % 20 == 0:
            assert len(set(window)) == len(window)


def test_summary_counts_a_miss_at_infinity():
    t = [serving.Timing(i, due=0.0, first_token=0.1 * (i + 1), done=1.0,
                        n_tokens=11) for i in range(19)]
    t.append(serving.Timing(19, due=0.0, failed=True))
    s = serving.summarize(t)
    assert s["misses"] == 1 and s["requests"] == 20
    assert s["ttft_p95_ms"] == pytest.approx(1900.0)   # rank 19 of 20
    assert s["ttft_p50_ms"] == pytest.approx(1000.0)
    t.append(serving.Timing(20, due=0.0))               # no first token
    assert math.isinf(serving.summarize(t)["ttft_p95_ms"])


def test_nearest_rank():
    assert serving.nearest_rank([3, 1, 2, 4], 50) == 2
    assert serving.nearest_rank([3, 1, 2, 4], 95) == 4
    assert serving.nearest_rank([5], 95) == 5


def test_lm_counts_by_hand():
    c = dict(num_layers=1, d_model=4, num_heads=2, num_kv_heads=1,
             head_dim=2, d_ff=8, vocab_size=10, sliding_window=3,
             tie_embeddings=True)
    # per layer: q 4x4, k 4x2, v 4x2, o 4x4, ffn 3x4x8, two norms; embed, norm
    assert counts.lm_params(c) == 16 + 8 + 8 + 16 + 96 + 8 + 40 + 4
    # an untied head adds its own 4x10
    assert counts.lm_params(dict(c, tie_embeddings=False)) == \
        counts.lm_params(c) + 40
    assert counts.causal_context(5, 3) == 1 + 2 + 3 + 3 + 3
    assert counts.causal_context(3, None) == 6
    # proj 2*4*(4+4) + 2*4*4 + 6*4*8 = 288 a token; head 2*4*10 = 80
    assert counts.lm_forward_flops(c, 1, 5) == 5 * (288 + 80) \
        + 4 * 2 * 2 * 12
    f, b = counts.lm_grad(c, 1, 5)
    assert f == 3 * counts.lm_forward_flops(c, 1, 5)
    f, b = counts.lm_decode(c, [0, 4])
    assert f == 2 * (288 + 80) + 4 * 2 * 2 * (1 + 3)
    assert b == counts.lm_params(c) * 4 + (1 + 3) * 2 * 1 * 2 * 4 + 2 * 10 * 4


def test_logreg_counts_by_hand():
    f, b = counts.logreg_step(B=2, m=3, d=5, bsz=1)
    assert f == 2 * 3 * (8 * 5 + 2 * 3 * 5)
    assert b == 2 * 3 * 6 * 4 + 2 * 3 * 6 * 5 * 4 + 9 * 4
    assert counts.fused_step_bytes(2, 3, 5) == (2 * 3 * 5 * 5 + 2 * 9) * 4
    cfg = {"m": 8, "batch_size": 1, "num_outer": 30, "beta": 1.07, "n0": 8,
           "dataset": {"n": 50000}}
    steps = sum(logreg_grid._lengths(cfg))
    assert logreg_grid.epochs_per_cell(cfg) == pytest.approx(
        30 + steps * 16 / 50000)


def test_trace_union_and_idle():
    ops = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40)]
    host = [("bench.traced_window", 0, 100), ("bench.step", 20, 30)]
    t = Trace(ops, host, 100e-9, 0, 100)
    assert t.busy_s == pytest.approx(30e-9)
    assert t.op_seconds(lambda n: n == "a") == pytest.approx(20e-9)
    idle = dict(t.idle_by_host())
    assert idle["bench.step"] == pytest.approx(10e-9)
    assert idle["host outside any span"] == pytest.approx(60e-9)
    bd = t.breakdown()
    assert bd["device_ops"][0][0] in ("a", "b")


def test_checks_worst_leaf_and_limits():
    want = {"a": 1.0, "b": 2.0, "c": 1e-9}
    got = {"a": 1.001, "b": 2.0, "c": 2e-9}
    # c's gap is over the median leaf's norm, not its own
    assert checks.worst_leaf_gap(got, want) == pytest.approx(0.001)
    ch = checks.Checks({"x": 0.1, "y": 0})
    ch.add("x", 0.05)
    ch.add("y", 0.0)
    assert ch.correct
    ch.add("x", float("nan"))
    assert not ch.correct


def test_inputs_repeat_for_a_seed():
    spec = {"n": 64, "d": 8, "row_norm": 3.0, "noise": 0.2, "active": 2}
    a = datasets.classification(spec, 4, 2**33 + 1, "cpu")
    b = datasets.classification(spec, 4, 2**33 + 1, "cpu")
    assert torch.equal(a["features"], b["features"])
    norms = torch.linalg.vector_norm(a["features"], dim=-1)
    assert torch.allclose(norms, torch.full_like(norms, 3.0), rtol=1e-5)
    model = {"num_layers": 1, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
             "head_dim": 4, "d_ff": 16, "vocab_size": 32,
             "tie_embeddings": False}
    w1 = lm_common.make_weights(model, 7, "cpu")
    w2 = lm_common.make_weights(model, 7, "cpu")
    for (n1, x1), (n2, x2) in zip(lm_common.leaves(w1),
                                  lm_common.leaves(w2)):
        assert n1 == n2 and torch.equal(x1, x2)
    assert sum(x.numel() for _, x in lm_common.leaves(w1)) == \
        counts.lm_params(model)
