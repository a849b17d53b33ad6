"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (the JAX package; ``repro_torch``, the port, begins
with the same letters, so names are compared whole).  Checked in a fresh
interpreter, since the test process itself may hold the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

from pbcore import env

env.prepare()

BENCH = Path(__file__).resolve().parent

PROBE = r"""
import json, sys
sys.path.insert(0, {bench!r})
from pbcore import env
env.prepare()
from pbcore import harness, tiny
for cell in sorted(tiny.OVERRIDES):
    harness.run_cell(cell, 3, 0.2, True, device="cpu", **tiny.OVERRIDES[cell])
import pbcore.frozen.counts, pbcore.frozen.serving, pbcore.trace
import reference.dense_lm, reference.lm_dpsvrg, reference.logreg_dpsvrg
print(json.dumps(sorted(sys.modules)))
"""


def test_forbidden_names_are_compared_whole():
    assert env.forbidden_loaded(["repro_torch", "repro_torch.core",
                                 "jaxtyping", "reproducible"]) == []
    assert env.forbidden_loaded(["repro.core", "jax._src"]) == \
        ["jax", "repro"]


def test_a_run_loads_no_jax_and_no_jax_package():
    environ = dict(os.environ)
    environ.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(bench=str(BENCH))],
        capture_output=True, text=True, env=environ, timeout=240,
        cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in {m.split(".")[0] for m in modules}
    assert env.forbidden_loaded(modules) == []


def test_sources_import_nothing_forbidden():
    """No harness source imports JAX, the JAX package or the old benchmark
    folder (the tests, which name them, aside)."""
    for f in BENCH.rglob("*.py"):
        if f.name.startswith("test_portbench_"):
            continue
        text = f.read_text()
        for bad in ("import jax", "from jax", "import repro\n",
                    "from repro ", "from repro.", "import repro.",
                    "import benchmarks", "from benchmarks"):
            assert bad not in text, (f, bad)
