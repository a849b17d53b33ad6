"""The reader of ``chunk_graph_share.serve`` on traces built by hand: the
share of ``engine.decode_chunk`` spans that hold an ``engine.replay`` span,
nothing read without the chunk spans; then a traced run of the serving cell
on the CPU, whose engine issues its chunks eagerly."""

from pbcore import env

env.prepare()


import pytest  # noqa: E402

from pbcore import harness, manifest, tiny  # noqa: E402
from pbcore.trace import WINDOW_SPAN, Trace  # noqa: E402

NAME = "chunk_graph_share.serve"


def _read(trace):
    return manifest.metric_reader(NAME).read(
        {"trace": trace, "work": {}, "counters": {}})


def _eager_trace():
    """A window of 1000 ns holding one engine step that issues its chunk
    eagerly, 400-690."""
    host = [(WINDOW_SPAN, 0, 1000),
            ("engine.step", 100, 700),
            ("engine.decode_chunk", 400, 690),
            ("engine.pull", 690, 700)]
    return Trace([("k", 0, 100), ("k", 700, 800)], host, 1000e-9, 0, 1000)


def test_chunk_graph_share_counts_the_chunks_that_hold_a_replay():
    eager = _eager_trace()
    assert _read(eager) == 0.0
    # a second chunk, 800-900, replaying the graph within it
    host = eager.host_spans + [("engine.step", 790, 910),
                               ("engine.decode_chunk", 800, 900),
                               ("engine.replay", 805, 840),
                               ("engine.pull", 900, 910)]
    t = Trace(eager.device_ops, host, 1000e-9, 0, 1000)
    assert _read(t) == pytest.approx(50.0)


def test_a_replay_outside_every_chunk_counts_for_none():
    eager = _eager_trace()
    stray = Trace(eager.device_ops, eager.host_spans
                  + [("engine.replay", 920, 930)], 1000e-9, 0, 1000)
    assert _read(stray) == 0.0


def test_chunk_graph_share_reads_nothing_without_chunks():
    bare = Trace([("k", 0, 100)], [(WINDOW_SPAN, 0, 1000)], 1000e-9, 0,
                 1000)
    assert _read(None) is None
    assert _read(bare) is None


def test_the_cpu_engine_issues_its_chunks_eagerly():
    cell = "danube_serve_poisson"
    res = harness.run_cell(cell, 2**31 + 5, 0.3, True, device="cpu",
                           **tiny.OVERRIDES[cell])
    assert res["correct"], res["checks"]
    assert res["metrics"][NAME]["value"] == 0.0
