"""``examples/torch_serve_lm.py`` against ``examples/serve_lm.py``: the
reference example's printed tokens (its own run, in a subprocess) equal the
port's ``generate`` loop on the reference's smoke-variant parameters
(``PRNGKey(0)``, carried across through numpy) and the example's own
inputs, for whisper-base (stub audio), llava-next-mistral-7b (stub image
prefix) and the default dense arch; and the port's example runs whole with
``--device cpu``.  Greedy tokens are compared exactly: the logits agree to
about 1e-6 (tests/test_torch_multimodal.py) and the models are tiny.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--batch", "2", "--prompt-len", "12", "--new", "6"]


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", os.path.join(ROOT, "examples", "torch_serve_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_rows(arch) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "serve_lm.py"),
         "--arch", arch, *ARGS], capture_output=True, text=True, env=env,
        check=True).stdout
    return [ast.literal_eval(ln.split(":", 1)[1].strip())
            for ln in out.splitlines() if ln.strip().startswith("seq")]


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b",
                                  "gemma2-9b"])
def test_generate_equals_the_reference_example(arch):
    ex = _example()
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    params = params_from_numpy(jax.tree.map(
        np.asarray, jtransformer.init_params(jcfg, jax.random.PRNGKey(0))),
        "cpu")
    toks, kw = ex.make_inputs(tcfg, 2, 12)
    gen, _, _ = ex.generate(tcfg, params, toks, kw, 6)
    assert gen.shape == (2, 6)
    want = _reference_rows(arch)
    assert len(want) == 2
    np.testing.assert_array_equal(gen, np.asarray(want, np.int32))


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_example_main_runs_on_cpu(arch, capsys):
    gen = _example().main(["--arch", arch, *ARGS, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={arch} (smoke variant), batch=2, device=cpu" in out
    assert out.count("  seq") == 2
    assert gen.shape == (2, 6)
    assert gen.min() >= 0 and gen.max() < 512
