"""The port's kernel benchmark (``benchmarks/pt_kernel_bench.py``) on the
CPU at a tiny size: ``run()`` gives every row, each kernel row records the
calls it made, the plain versions agree with themselves (max abs err 0),
``kernel_stats`` holds the fused histories to the plain ones, ``--json``
merges its section into a file, and without a card the default device
raises.  On the CPU no kernel launches.  The same bench on a card is in
``tests/test_torch_card.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import pt_kernel_bench  # noqa: E402
from repro_torch.kernels.fused_update import ops  # noqa: E402

TINY = dict(large_d=256, paper_steps=50)


def _counts():
    return (ops.launches, ops.launches_svrg_step, ops.launches_mix_prox)


def test_run_on_cpu_gives_every_row_and_counts_its_calls():
    before = _counts()
    rows = pt_kernel_bench.run(0.02, "cpu", rows=8, **TINY)
    assert _counts() == before                 # the CPU launches nothing
    names = [r.name for r in rows]
    assert names == ["kernel/unfused_chain_torch", "kernel/plain_chain",
                     "kernel/svrg_mix_check", "kernel/svrg_step",
                     "kernel/mix_prox", "kernel/svrg_mix_chain",
                     "kernel/resident_paper_scale_auto",
                     "kernel/resident_large_d_fused",
                     "kernel/resident_large_d_moving", "kernel/step_buf"]
    by_name = {r.name: r for r in rows}
    assert set(by_name["kernel/svrg_mix_check"].data["max_abs_err"]
               .values()) == {0.0}
    calls = pt_kernel_bench.WARMUP + pt_kernel_bench.ITERS
    assert by_name["kernel/svrg_step"].data["calls"] == {"svrg_step": calls}
    assert by_name["kernel/svrg_mix_chain"].data["calls"] == {
        "svrg_step": calls, "mix_prox": calls}
    for r in rows:
        assert np.isfinite(r.us_per_call) and r.us_per_call >= 0.0
        # no share of the card's bound is claimed for a CPU time
        assert "share" not in r.derived


def test_kernel_stats_on_cpu():
    ks = pt_kernel_bench.kernel_stats(0.02, "cpu", **TINY)
    ps, ld = ks["paper_scale"], ks["large_d"]
    assert (ps["param_dim"], ps["steps"], ps["algorithm"]) == (30, 50,
                                                               "dspg")
    # the port's FUSED_MIN_D is 30: "auto" takes the fused step at d = 30
    assert ps["auto_picks_fused"] is True
    assert (ld["param_dim"], ld["gossip"], ld["algorithm"]) == (
        256, "banded", "loopless_dpsvrg")
    for sec in (ps, ld):
        assert sec["fused_launches"] == 0       # plain versions on the CPU
        assert sec["history_max_abs_diff"] <= 1e-5
        for kind, hist in sec["objective"].items():
            assert np.all(np.isfinite(hist)), kind
    assert (ld["transfers_h2d"], ld["transfers_d2h"]) == (1, 1)
    # the moving-iterate twin of the large-d row: the iterate leaves 0
    mv = ks["large_d_moving"]
    assert (mv["param_dim"], mv["lam"]) == (256, pt_kernel_bench.MOVING_LAM)
    assert 0 < mv["nonzero"] <= mv["params"] == 8 * 256
    assert mv["fused_launches"] == 0 and mv["history_max_abs_diff"] <= 1e-5
    assert (mv["graphs_built"], mv["replays"]) == (0, 0)  # none on the CPU
    assert set(ks["step_buf"]) == {"paper", "large"}
    assert ks["step_buf"]["large"]["plain_max_abs_diff"] == 0.0
    untimed = pt_kernel_bench.kernel_stats(0.02, "cpu", timed=False, **TINY)
    assert untimed["large_d"]["fused_ms_per_step"] is None
    np.testing.assert_array_equal(untimed["large_d"]["objective"]["fused"],
                                  ld["objective"]["fused"])


def test_json_merges_the_kernels_section(tmp_path, monkeypatch):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps({"runner": {"kept": 1}}))
    orig = pt_kernel_bench.kernel_stats
    monkeypatch.setattr(pt_kernel_bench, "kernel_stats",
                        lambda scale, device: orig(scale, device, **TINY))
    pt_kernel_bench.main(["--device", "cpu", "--json", str(path)])
    out = json.loads(path.read_text())
    assert out["runner"] == {"kept": 1}
    assert out["kernels"]["paper_scale"]["device"] == "cpu"
    assert out["kernels"]["large_d"]["param_dim"] == 256


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pt_kernel_bench.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        pt_kernel_bench.kernel_stats(0.02)


def test_bench_imports_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import benchmarks.pt_kernel_bench\n"
            "print(sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
