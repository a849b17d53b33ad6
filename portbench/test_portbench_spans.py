"""The readers of the program's spans on traces built by hand: host time
a span, idle gaps put down to the innermost open span (a gap inside
``engine.prefill`` inside ``engine.admit`` counted once, as admission),
the two idle shares within ``idle_share.serve``, and nothing read where the
spans or the device's operations are absent; then traced runs of both
danube cells on the CPU, whose span readers read numbers."""

from pbcore import env

env.prepare()


import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pbcore import harness, manifest, tiny  # noqa: E402
from pbcore.idle import idle_by_span  # noqa: E402
from pbcore.trace import WINDOW_SPAN, Trace  # noqa: E402

SPAN_READERS = ("admit_ms.serve", "chunk_dispatch_ms.serve",
                "idle_admit_share.serve", "idle_chunk_share.serve",
                "loop_start_ms.train")


def _read(name, trace):
    return manifest.metric_reader(name).read(
        {"trace": trace, "work": {}, "counters": {}})


def _serving_trace(ops=None):
    """A window of 1000 ns: busy 0-100, 300-400, 700-800; one engine step
    admitting (its idle gap 100-300 inside engine.prefill) and issuing a
    chunk (its gap 400-700), and an idle tail outside any span."""
    ops = [("k", 0, 100), ("k", 300, 400), ("k", 700, 800)] \
        if ops is None else ops
    host = [(WINDOW_SPAN, 0, 1000),
            ("engine.step", 100, 700),
            ("engine.admit", 100, 300),
            ("engine.upload", 100, 140),
            ("engine.prefill", 150, 290),
            ("engine.splice", 290, 300),
            ("engine.decode_chunk", 400, 690),
            ("engine.pull", 690, 700)]
    return Trace(ops, host, 1000e-9, 0, 1000)


def test_span_readers_on_a_hand_built_serving_trace():
    t = _serving_trace()
    assert _read("admit_ms.serve", t) == pytest.approx(200e-6)
    assert _read("chunk_dispatch_ms.serve", t) == pytest.approx(290e-6)
    # the gap 100-300 lies in engine.prefill inside engine.admit: counted
    # once, as admission, not once for each open span
    assert _read("idle_admit_share.serve", t) == pytest.approx(20.0)
    assert _read("idle_chunk_share.serve", t) == pytest.approx(30.0)
    assert _read("idle_share.serve", t) == pytest.approx(70.0)
    assert dict(t.idle_by_host())["host outside any span"] == \
        pytest.approx(200e-9)


def test_a_gap_under_each_admission_part_counts_as_admission():
    # busy everywhere but one gap centred in the part named
    for part, (s, e) in {"engine.upload": (100, 140),
                         "engine.prefill": (150, 290),
                         "engine.splice": (290, 300)}.items():
        ops = [("k", 0, s), ("k", e, 1000)]
        share = _read("idle_admit_share.serve", _serving_trace(ops))
        assert share == pytest.approx((e - s) / 10), part
        assert _read("idle_chunk_share.serve", _serving_trace(ops)) == 0.0


def test_loop_start_is_per_train_loop_call():
    host = [(WINDOW_SPAN, 0, 1000)]
    for r in range(2):            # two rounds, a train_loop call each
        o = 400 * r
        host += [("train.build", o, o + 50), ("train.plan", o + 50, o + 80),
                 ("train.stage", o + 80, o + 100),
                 ("train.step", o + 100, o + 390)]
    t = Trace([("k", 0, 1000)], host, 1000e-9, 0, 1000)
    assert _read("loop_start_ms.train", t) == pytest.approx(100e-6)


def test_nothing_is_read_without_the_spans_or_the_device():
    bare = Trace([("k", 0, 100)], [(WINDOW_SPAN, 0, 1000)], 1000e-9, 0,
                 1000)
    for name in SPAN_READERS:
        assert _read(name, None) is None
        assert _read(name, bare) is None, name
    # spans but no device operation (a CPU run): the host times read, the
    # idle shares do not, as idle_share.serve does not
    host_only = _serving_trace(ops=[])
    assert _read("idle_share.serve", host_only) is None
    assert _read("idle_admit_share.serve", host_only) is None
    assert _read("idle_chunk_share.serve", host_only) is None
    assert _read("admit_ms.serve", host_only) == pytest.approx(200e-6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_idle_shares_split_idle_share(seed):
    """Random steps of admissions and chunks, random device work: the two
    shares never add up to more than the window's idle share."""
    rng = np.random.default_rng(seed)
    host, ops, now = [], [], 0
    for _ in range(20):
        step0 = now
        for _ in range(int(rng.integers(0, 3))):
            a = now
            for part in ("engine.upload", "engine.prefill",
                         "engine.splice"):
                d = int(rng.integers(1, 50))
                host.append((part, now, now + d))
                now += d
            host.append(("engine.admit", a, now))
        d = int(rng.integers(10, 200))
        host.append(("engine.decode_chunk", now, now + d))
        now += d
        host.append(("engine.pull", now, now + 5))
        now += 5
        host.append(("engine.step", step0, now))
        now += int(rng.integers(0, 30))
    for s in np.sort(rng.integers(0, now, size=40)):
        ops.append(("k", int(s), int(s + rng.integers(1, 40))))
    end = max(now, max(e for _, _, e in ops))
    t = Trace(sorted(ops, key=lambda o: o[1]),
              [(WINDOW_SPAN, 0, end)] + host, end * 1e-9, 0, end)
    a = _read("idle_admit_share.serve", t)
    c = _read("idle_chunk_share.serve", t)
    assert a > 0 and c > 0
    assert a + c <= _read("idle_share.serve", t) + 1e-9


@pytest.mark.parametrize("seed", range(6))
def test_the_sweep_labels_idle_time_as_idle_by_host(seed):
    """Spans in any arrangement (overlapping, nested, identical intervals
    under two names, ends shared), operations reaching past the window:
    the sweep gives ``idle_by_host``'s labels and seconds."""
    rng = np.random.default_rng(seed)
    names = ["a", "b", "c", "engine.admit", "engine.decode_chunk"]
    host = [(WINDOW_SPAN, 100, 5000)]
    for _ in range(int(rng.integers(0, 60))):
        s = int(rng.integers(0, 5200))
        e = s + int(rng.integers(0, 800))
        host.append((str(rng.choice(names)), s, e))
        if rng.random() < 0.2:                   # the same interval again
            host.append((str(rng.choice(names)), s, e))
    ops = sorted((("k", s, s + int(d)) for s, d in zip(
        rng.integers(-200, 5300, size=int(rng.integers(0, 80))),
        rng.integers(0, 120, size=80))), key=lambda o: o[1])
    t = Trace(ops, host, 4900e-9, 100, 5000)
    want = dict(t.idle_by_host())
    got = idle_by_span(t)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-15), k


@pytest.mark.parametrize("cell,names", [
    ("danube_serve_poisson", ("admit_ms.serve", "chunk_dispatch_ms.serve")),
    ("danube_train_dpsvrg", ("loop_start_ms.train",))])
def test_traced_tiny_runs_read_the_program_spans(cell, names):
    res = harness.run_cell(cell, 2**31 + 5, 0.3, True, device="cpu",
                           **tiny.OVERRIDES[cell])
    assert res["correct"], res["checks"]
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
    # no device operations on the CPU: the idle shares are left out
    assert not {"idle_admit_share.serve", "idle_chunk_share.serve"} \
        & set(res["metrics"])
