"""``benchmarks/pt_smoke_sampler.py``: the stack sampler that times
``chip_smoke.py``'s phases.  Here on the CPU the script stops at its first
check (no card), and the sampler still writes its report."""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import pt_smoke_sampler  # noqa: E402

ROOT = pt_smoke_sampler.ROOT


def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_sampler_charges_the_function_on_the_stack():
    sampler = pt_smoke_sampler.Sampler(0.005)
    sampler.start()
    _busy(0.3)
    sampler.stop()
    key = [k for k in sampler.inclusive if k.endswith(":_busy")]
    assert len(key) == 1
    # the busy loop holds the GIL, so samples come late; each charges the
    # time since the previous one, and most of the 0.3 s lands in the loop
    assert sampler.inclusive[key[0]] > 0.2
    assert sampler.own[key[0]] > 0.2
    report = sampler.report()
    assert "# inclusive seconds, this repository's functions" in report
    assert key[0] in report


def test_sampler_reports_when_the_script_fails(tmp_path):
    out = tmp_path / "profile.txt"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks",
                                      "pt_smoke_sampler.py"),
         "--out", str(out)], capture_output=True, text=True, cwd=tmp_path,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    # without a card chip_smoke.py exits 1, and so does the sampler
    assert proc.returncode == 1
    assert "FAIL" in proc.stderr
    text = out.read_text()
    assert text.startswith("# chip_smoke.py under the sampler: ")
    assert "chip_smoke.py:1:<module>" in text
