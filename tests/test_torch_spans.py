"""The port's spans (``repro_torch.spans``) on the CPU: with the profiler
off a span is the one shared null context and records nothing; under
``torch.profiler`` the serving engine and ``train_loop`` record their
spans, each child inside its parent, as many as the work they wrap; and
the profiler changes no served token and no bit of a history."""

import collections
import pathlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.core import graphs, prox
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data.loader import LMLoader
from repro_torch.models import transformer
from repro_torch.models.api import ModelConfig
from repro_torch.serve.engine import ResidentEngine
from repro_torch.serve.scheduler import Request
from repro_torch.train import trainer

torch.set_num_threads(1)

SERVE = ModelConfig(name="tiny-spans-serve", arch_type="dense", num_layers=1,
                    d_model=16, num_heads=2, num_kv_heads=1, d_ff=32,
                    vocab_size=64)
TRAIN = ModelConfig(name="tiny-spans-train", arch_type="dense", num_layers=1,
                    d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                    vocab_size=64)
M = 4
TOKENS = np.random.default_rng(7).integers(0, 64, size=2400).astype(np.int32)
# two refreshes (steps 0 and 4); records at 0, 4 and 7
TC = dict(num_steps=8, snapshot_every=4, log_every=4, alpha=0.05,
          consensus_rounds=2, seed=0)


def _recorded(fn):
    """``fn()``'s result and the spans it recorded under the profiler:
    [(name, start_ns, end_ns)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            found.append((e.name(), e.start_ns(),
                          e.start_ns() + e.duration_ns()))
    return out, found


def _counts(found) -> collections.Counter:
    return collections.Counter(n for n, _, _ in found)


def _children(found, parent: str, child: str) -> list:
    """For each ``parent`` span, how many ``child`` spans lie inside it;
    every ``child`` must lie inside one."""
    parents = [(s, e) for n, s, e in found if n == parent]
    held = [0] * len(parents)
    for n, s, e in found:
        if n != child:
            continue
        inside = [i for i, (ps, pe) in enumerate(parents)
                  if ps <= s and e <= pe]
        assert len(inside) == 1, (child, s, e)
        held[inside[0]] += 1
    return held


def test_a_span_with_the_profiler_off_is_the_shared_null_context(
        monkeypatch):
    made = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: made.append(name))
    assert not torch.autograd._profiler_enabled()
    first, second = spans.span("engine.step"), spans.span("train.step")
    assert first is second is spans._OFF
    with first:
        with second:            # nested, as spans are
            pass
    assert made == []


def _nested():
    with spans.span("outer"):
        for _ in range(2):
            with spans.span("inner"):
                pass


def test_a_span_under_the_profiler_is_a_record_function_range():
    _, found = _recorded(_nested)
    assert _counts(found) == {"outer": 1, "inner": 2}
    assert _children(found, "outer", "inner") == [2]


def _serve():
    params = transformer.init_params(SERVE, 0, device="cpu")
    eng = ResidentEngine(SERVE, params, max_slots=2, max_len=32, chunk=3)
    rng = np.random.default_rng(3)
    for uid, n in enumerate((5, 9, 7)):
        eng.submit(Request(uid=uid, tokens=rng.integers(0, 64, size=n)
                           .astype(np.int32), max_new_tokens=4 + uid))
    steps = 0
    while eng.busy:
        eng.step()
        steps += 1
    return eng.outputs, dict(eng.transfers), steps


def test_the_engine_records_its_spans():
    (outputs, transfers, steps), found = _recorded(_serve)
    c = _counts(found)
    assert len(outputs) == 3 and transfers["chunks"] >= 2
    assert c["engine.step"] == steps
    assert c["engine.admit"] == 3 == transfers["h2d"]
    for child in ("engine.upload", "engine.prefill", "engine.splice"):
        assert _children(found, "engine.admit", child) == [1, 1, 1]
    assert c["engine.decode_chunk"] == c["engine.pull"] == \
        transfers["chunks"]
    for child in ("engine.admit", "engine.decode_chunk", "engine.pull"):
        assert sum(_children(found, "engine.step", child)) == c[child]
    # the third request waits for a slot: a later step admits it
    assert sorted(_children(found, "engine.step", "engine.admit"))[-1] == 2


def _train(resident: bool, ckpt_dir=None):
    tc = trainer.TrainerConfig(**dict(
        TC, ckpt_dir=ckpt_dir, ckpt_every=4 if ckpt_dir else 0))
    return trainer.train_loop(
        TRAIN, prox.l1(1e-4), graphs.b_connected_ring_schedule(M, b=2,
                                                               seed=0),
        LMLoader(TOKENS, num_nodes=M, per_node_batch=2, seq_len=16, seed=1),
        tc, exec=ExecSpec(resident=resident, device="cpu"))


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "host"])
def test_train_loop_records_its_spans(resident):
    hist, found = _recorded(lambda: _train(resident))
    c = _counts(found)
    n = TC["num_steps"]
    assert c["train.build"] == 1
    assert c["train.plan"] == (1 if resident else 0)
    # one staging copy, or the host loop's batch and phi a step
    assert c["train.stage"] == (1 if resident else n)
    assert c["train.refresh"] == 2
    assert c["train.step"] == n
    for child in ("train.grad", "train.mix"):
        assert _children(found, "train.step", child) == [1] * n
    assert c["train.record"] == hist["transfers"]["d2h"] == 3
    assert c["train.ckpt"] == 0


def test_train_loop_spans_each_checkpoint(tmp_path):
    hist, found = _recorded(lambda: _train(False, str(tmp_path)))
    c = _counts(found)
    # periodic saves after steps 3 and 7; the final one is the second
    assert c["train.ckpt"] == 2
    assert c["train.record"] + c["train.ckpt"] == hist["transfers"]["d2h"]


def _same_tree(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "host"])
def test_the_profiler_changes_no_bit_of_a_history(resident):
    on, _ = _recorded(lambda: _train(resident))
    off = _train(resident)
    for key in ("step", "loss", "v_norm", "alpha", "wire_bytes"):
        assert on[key] == off[key], key
    assert _same_tree(on["final_state"].params, off["final_state"].params)


def test_train_sweep_records_the_steps_spans_under_its_vmap():
    """The unsharded step's spans lie outside the node vmap but inside
    ``train_sweep``'s vmap over the cells: recorded once a step there, and
    the grid's history is unchanged."""
    def sweep():
        tc = trainer.TrainerConfig(**TC)
        return trainer.train_sweep(
            TRAIN, prox.l1, graphs.b_connected_ring_schedule(M, b=2, seed=0),
            LMLoader(TOKENS, num_nodes=M, per_node_batch=2, seq_len=16,
                     seed=1),
            tc, {"lam": [1e-4, 1e-3]}, ExecSpec(resident=True, device="cpu"))

    on, found = _recorded(sweep)
    c = _counts(found)
    assert c["train.grad"] == c["train.mix"] == TC["num_steps"]
    off = sweep()
    assert np.array_equal(on["loss"], off["loss"])
    assert np.array_equal(on["v_norm"], off["v_norm"])


def test_every_span_of_the_port_goes_through_the_helper():
    """No module of the port but the helper makes a ``record_function``
    range (its name in a docstring aside)."""
    src = pathlib.Path(spans.__file__).parent
    users = sorted(
        f.relative_to(src).as_posix() for f in src.rglob("*.py")
        if re.search(r"record_function\(|import.*\brecord_function\b",
                     f.read_text()))
    assert users == ["spans.py"]


def test_the_profiler_changes_no_served_token():
    (on, ledger_on, _), _ = _recorded(_serve)
    off, ledger_off, _ = _serve()
    assert ledger_on == ledger_off
    assert sorted(on) == sorted(off)
    for uid in on:
        assert np.array_equal(on[uid], off[uid])
