"""``benchmarks/pt_serve_bench.py`` on the CPU: the reference bench's model,
stream, slots, ``max_len``, chunk and shapes; host batcher and resident
engine outputs equal over the stream, the engine's ledger O(1) per chunk;
the TTFT / TPOT percentiles and the prefill/decode split reported; and
``--json`` merging its ``serve`` section into the file, keeping the
others."""

import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import pt_serve_bench, serve_bench  # noqa: E402

torch.set_num_threads(1)


def test_the_bench_has_the_reference_settings():
    assert dataclasses.asdict(pt_serve_bench.TINY) == \
        dataclasses.asdict(serve_bench.TINY)
    assert dataclasses.asdict(pt_serve_bench._STREAM) == \
        dataclasses.asdict(serve_bench._STREAM)
    assert (pt_serve_bench._SLOTS, pt_serve_bench._MAX_LEN,
            pt_serve_bench._CHUNK) == (serve_bench._SLOTS,
                                       serve_bench._MAX_LEN,
                                       serve_bench._CHUNK)
    smoke, ref_smoke = pt_serve_bench._smoke_cfg(), serve_bench._smoke_cfg()
    assert dataclasses.replace(smoke, use_flash=False,
                               use_fused_norm=False) == \
        type(smoke)(**dataclasses.asdict(ref_smoke))
    assert smoke.use_flash and smoke.use_fused_norm


def test_the_bench_runs_whole_on_the_cpu_and_merges_its_section(tmp_path,
                                                                 capsys):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps({"runner": {"kept": 1}}))
    ss = pt_serve_bench.main(["--device", "cpu", "--iters", "1", "--json",
                              str(path)])
    printed = capsys.readouterr().out
    out = json.loads(path.read_text())
    assert out["runner"] == {"kept": 1}
    assert out["serve"] == json.loads(json.dumps(ss))
    assert ss["device"] == "cpu" and ss["outputs_equal"]
    tr = ss["transfers"]
    assert tr["resident"] == [24, tr["chunks"]] and tr["admissions"] == 24
    assert ss["stream"]["tokens"] == sum(
        r.max_new_tokens for r in pt_serve_bench.stream_lib.make_requests(
            pt_serve_bench._STREAM))
    for key in ("ttft_ms", "tpot_ms"):
        p = ss[key]
        assert 0 <= p["p50"] <= p["p95"] <= p["p99"]
    for shape in ("tiny", "lm"):
        pd = ss["prefill_decode"][shape]
        assert pd["prefill_ms"] > 0 and pd["decode_ms_per_token"] > 0
    assert ss["prefill_decode"]["lm"]["prompt_len"] == 32
    assert "ttft p50/p95/p99" in printed and "prefill/lm" in printed


def test_the_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pt_serve_bench.serve_stats()
