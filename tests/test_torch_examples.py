"""``examples/torch_decentralized_logreg.py`` and
``examples/torch_continuous_batching.py`` against the reference examples
they port, with ``--device cpu``.

The logistic-regression example: each of its settings' histories against
the reference's ``run_setting`` (objectives at rtol 1e-5, the consensus
at rtol 1e-3, steps and communication rounds exactly), and its printed
lines against the reference's (the text equal, integers equal, printed
floats within their last printed digit).  The port runs each setting
resident with ``kernel="auto"`` (the fused step's plain version on the
CPU), the reference on its host loop: the same ``np.random`` draws, float32
sums in other orders.

The continuous-batching example: every uid's tokens equal the reference
example's on the reference's ``PRNGKey(0)`` parameters (carried across
through numpy), its submissions print the same lines, and both refuse a
frontend arch.
"""

import ast
import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch.convert import params_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OBJ_RTOL = 1e-5
CONS_RTOL = 1e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue(), out


# ---------------------------------------------------------------------------
# decentralized_logreg
# ---------------------------------------------------------------------------

# the example's settings: (b, lam, single)
SETTINGS = [(1, 0.01, False), (3, 0.01, False), (7, 0.01, False),
            (1, 0.001, False), (1, 0.1, False), (3, 0.01, True)]


@pytest.mark.parametrize("b,lam,single", SETTINGS)
def test_logreg_setting_matches_the_reference(b, lam, single):
    ref, port = _load("decentralized_logreg"), _load(
        "torch_decentralized_logreg")
    want = ref.run_setting("mnist_like", 8, b, lam, 0.2, 9, 0.02,
                           single=single)
    got = port.run_setting("mnist_like", 8, b, lam, 0.2, 9, 0.02,
                           single=single, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g.steps),
                                      np.asarray(w.steps))
        np.testing.assert_array_equal(np.asarray(g.comm_rounds),
                                      np.asarray(w.comm_rounds))
        np.testing.assert_allclose(g.objective, np.asarray(w.objective),
                                   rtol=OBJ_RTOL)
        np.testing.assert_allclose(g.consensus, np.asarray(w.consensus),
                                   rtol=CONS_RTOL, atol=1e-9)


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _same_printed(got: str, want: str) -> None:
    """Lines equal but for their floats, each within its last printed
    digit of the reference's (or rtol 1e-5); integers exactly."""
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert _NUM.sub("#", g) == _NUM.sub("#", w)
        for gs, ws in zip(_NUM.findall(g), _NUM.findall(w)):
            if re.fullmatch(r"-?\d+", ws):
                assert gs == ws, (g, w)
                continue
            digits = ws.split("e")[0].split(".")[-1]
            unit = 10.0 ** -len(digits) * (10.0 ** int(ws.split("e")[1])
                                           if "e" in ws else 1.0)
            assert abs(float(gs) - float(ws)) <= max(
                unit, OBJ_RTOL * abs(float(ws))), (g, w)


def test_logreg_example_prints_the_reference_lines(monkeypatch):
    ref, port = _load("decentralized_logreg"), _load(
        "torch_decentralized_logreg")
    monkeypatch.setattr(sys, "argv", ["decentralized_logreg.py"])
    want, _ = _stdout(ref.main)
    got, _ = _stdout(port.main, ["--device", "cpu"])
    assert "== graph connectivity sweep (Fig. 5): b in {1, 3, 7} ==" in got
    assert got.count("\n") == 11
    _same_printed(got, want)


# ---------------------------------------------------------------------------
# continuous_batching
# ---------------------------------------------------------------------------

def _uid_tokens(text: str) -> dict:
    return {int(m.group(1)): ast.literal_eval(m.group(2))
            for m in re.finditer(r"^uid=(\d+): (\[.*\])$", text, re.M)}


def test_batching_example_prints_the_reference_tokens(monkeypatch):
    ref, port = _load("continuous_batching"), _load(
        "torch_continuous_batching")
    monkeypatch.setattr(sys, "argv", ["continuous_batching.py"])
    want, _ = _stdout(ref.main)
    cfg = jconfigs.smoke_variant(jconfigs.get_config("h2o-danube-1.8b"))
    params = params_from_numpy(jax.tree.map(
        np.asarray, jtransformer.init_params(cfg, jax.random.PRNGKey(0))),
        "cpu")
    got, outs = _stdout(port.main, ["--device", "cpu"], params=params)
    want_tokens = _uid_tokens(want)
    assert sorted(want_tokens) == list(range(7))
    assert _uid_tokens(got) == want_tokens
    assert {u: v.tolist() for u, v in outs.items()} == want_tokens
    submitted = [ln for ln in want.splitlines()
                 if ln.startswith("submitted")]
    assert len(submitted) == 7
    assert [ln for ln in got.splitlines()
            if ln.startswith("submitted")] == submitted
    assert "7 requests (" in got and "through 3 slots in" in got


def test_batching_example_runs_whole_from_its_seed():
    outs = _stdout(_load("torch_continuous_batching").main,
                   ["--device", "cpu", "--arch", "gemma2-9b", "--slots", "2",
                    "--requests", "3"])[1]
    assert sorted(outs) == [0, 1, 2]
    assert all(3 <= len(v) < 10 and v.min() >= 0 and v.max() < 512
               for v in outs.values())


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_batching_example_refuses_a_frontend_arch(arch):
    with pytest.raises(SystemExit, match="text arch"):
        _load("torch_continuous_batching").main(["--device", "cpu",
                                                 "--arch", arch])
