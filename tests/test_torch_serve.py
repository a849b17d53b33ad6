"""The port's serving stack (``repro_torch.serve``) on the CPU: the resident
engine and the host batcher against each other, against standalone greedy
decode in the port, and against the JAX package's engine on the same
prompts and parameters (tokens and transfer ledger); the seeded streams and
their summaries against the reference's, bit for bit.

Greedy tokens are compared exactly: both packages compute the same float32
logits to ~1e-6 (tests/test_torch_models.py), and the models here are tiny,
so no argmax sits near a tie.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.serve import metrics as jmetrics, stream as jstream
from repro.serve.engine import ResidentEngine as JResidentEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer
from repro_torch.models.api import ModelConfig
from repro_torch.serve import metrics, stream
from repro_torch.serve.engine import ResidentEngine
from repro_torch.serve.scheduler import ContinuousBatcher, Request

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="tiny-serve", arch_type="dense", num_layers=1, d_model=16,
            num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64)
CFG = ModelConfig(**TINY)


def _params(cfg, seed=0):
    return transformer.init_params(cfg, seed, device="cpu")


def _requests(cfg, n, seed=0, lens=(4, 6, 9), new=(1, 10), cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                           size=int(rng.choice(lens)))
                .astype(np.int32), max_new_tokens=int(rng.integers(*new)))
            for i in range(n)]


def _second_best(logits):
    """Non-greedy sampler (both engines take it)."""
    return torch.argsort(logits, dim=-1)[..., -2].to(torch.int32)


def _run_both(cfg, params, reqs, *, slots=3, max_len=64, chunk=4,
              eos_id=None, sampler=None):
    host = ContinuousBatcher(cfg, params, max_slots=slots, max_len=max_len,
                             eos_id=eos_id, sampler=sampler)
    for r in reqs:
        host.submit(r)
    host_out = host.run_until_done()
    eng = ResidentEngine(cfg, params, max_slots=slots, max_len=max_len,
                         eos_id=eos_id, sampler=sampler, chunk=chunk)
    for r in reqs:
        eng.submit(r)
    eng_out = eng.run_until_done()
    assert set(host_out) == set(eng_out) == {r.uid for r in reqs}
    for uid in host_out:
        np.testing.assert_array_equal(host_out[uid], eng_out[uid])
    return eng


def test_engine_matches_host_batcher_more_requests_than_slots():
    eng = _run_both(CFG, _params(CFG), _requests(CFG, 8), slots=3, chunk=4)
    assert eng.transfers["h2d"] == 8
    assert eng.transfers["d2h"] == eng.transfers["chunks"]


def test_engine_matches_standalone_greedy_smoke_arch():
    """Sliding-window smoke arch; the 20-token prompt is longer than the
    window of 16."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    params = _params(cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 20)]
    eng = ResidentEngine(cfg, params, max_slots=2, max_len=64, chunk=3)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, tokens=p, max_new_tokens=5))
    outs = eng.run_until_done()
    for i, p in enumerate(prompts):
        logits, cache = transformer.prefill(cfg, params,
                                            torch.from_numpy(p)[None],
                                            max_len=64)
        ref, cur = [], torch.argmax(logits, -1).to(torch.int32)
        for _ in range(5):
            ref.append(int(cur[0]))
            logits, cache = transformer.decode_step(cfg, params, cache, cur)
            cur = torch.argmax(logits, -1).to(torch.int32)
        np.testing.assert_array_equal(outs[i], np.asarray(ref, np.int32))


@pytest.mark.parametrize("arch,chunk", [("h2o-danube-1.8b", 4),
                                        ("gemma2-9b", 3)])
def test_engine_tokens_and_ledger_equal_the_jax_engine(arch, chunk):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(lens=(5, 12, 20), new=(2, 9))
    jreqs = _requests(tcfg, 5, seed=3, cls=JRequest, **kw)
    treqs = _requests(tcfg, 5, seed=3, **kw)
    jeng = JResidentEngine(jcfg, jp, max_slots=2, max_len=48, chunk=chunk)
    teng = ResidentEngine(tcfg, tp, max_slots=2, max_len=48, chunk=chunk)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jout, tout = jeng.run_until_done(), teng.run_until_done()
    assert set(tout) == set(jout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], jout[uid])
    assert teng.transfers == jeng.transfers


def test_engine_with_the_kernel_routes_equals_the_plain_engine():
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    params = _params(cfg, seed=2)
    reqs = _requests(cfg, 4, seed=6, lens=(6, 18), new=(3, 7))
    outs = []
    for c in (cfg, cfg.scaled(use_flash=True, use_fused_norm=True)):
        eng = ResidentEngine(c, params, max_slots=2, max_len=40, chunk=4)
        for r in reqs:
            eng.submit(r)
        outs.append(eng.run_until_done())
    for uid in outs[0]:
        np.testing.assert_array_equal(outs[0][uid], outs[1][uid])


def test_engine_eos_mid_chunk_retirement():
    params = _params(CFG)
    reqs = _requests(CFG, 6, seed=3, new=(8, 20))
    probe = ResidentEngine(CFG, params, max_slots=2, max_len=64)
    for r in reqs:
        probe.submit(r)
    outs = probe.run_until_done()
    eos = int(outs[0][len(outs[0]) // 2])
    eng = _run_both(CFG, params, reqs, slots=2, chunk=4, eos_id=eos)
    for uid, out in eng.outputs.items():
        if eos in out.tolist():
            assert out.tolist().index(eos) == len(out) - 1, uid


def test_engine_custom_sampler_matches_host():
    _run_both(CFG, _params(CFG), _requests(CFG, 7, seed=4), slots=2,
              chunk=5, sampler=_second_best)


def test_engine_chunk_size_invariance():
    params = _params(CFG)
    reqs = _requests(CFG, 5, seed=5)
    outs = {}
    for chunk in (1, 4, 16):
        eng = ResidentEngine(CFG, params, max_slots=2, max_len=64,
                             chunk=chunk)
        for r in reqs:
            eng.submit(r)
        outs[chunk] = eng.run_until_done()
    for chunk in (4, 16):
        assert set(outs[1]) == set(outs[chunk])
        for uid in outs[1]:
            np.testing.assert_array_equal(outs[1][uid], outs[chunk][uid])


def test_engine_rejects_prompt_exceeding_cache():
    eng = ResidentEngine(CFG, _params(CFG), max_slots=1, max_len=16)
    eng.submit(Request(uid=0, tokens=np.zeros(16, np.int32),
                       max_new_tokens=2))
    with pytest.raises(ValueError, match="max_len"):
        eng.step()


def test_engine_rejects_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        ResidentEngine(CFG, _params(CFG), max_slots=1, max_len=16, chunk=0)


def test_image_and_audio_requests_wait_for_their_slice():
    eng = ResidentEngine(CFG, _params(CFG), max_slots=1, max_len=16)
    eng.submit(Request(uid=0, tokens=np.zeros(4, np.int32),
                       image_embeds=np.zeros((2, 16), np.float32)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        eng.step()


# ---------------------------------------------------------------------------
# streams and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival", ["poisson", "bursty", "batch"])
def test_make_requests_is_bit_equal_to_the_reference(arrival):
    kw = dict(num_requests=12, vocab_size=300, arrival=arrival, rate=5.0,
              burst=3, prompt_lens=(4, 9, 17), new_low=2, new_high=11,
              seed=42)
    got = stream.make_requests(stream.StreamConfig(**kw))
    want = jstream.make_requests(jstream.StreamConfig(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.uid, g.arrival, g.max_new_tokens) == \
            (w.uid, w.arrival, w.max_new_tokens)
        assert g.tokens.dtype == w.tokens.dtype
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_stream_config_validation_matches():
    for bad in (dict(arrival="uniform"), dict(rate=0.0),
                dict(new_low=5, new_high=2)):
        with pytest.raises(ValueError):
            stream.StreamConfig(**bad)
        with pytest.raises(ValueError):
            jstream.StreamConfig(**bad)


def test_summarize_equals_the_reference():
    rng = np.random.default_rng(0)
    kw = []
    for uid in range(9):
        arrival = float(rng.random())
        first = arrival + float(rng.random())
        kw.append(dict(uid=uid, arrival=arrival, first_token=first,
                       done=first + float(rng.random()),
                       n_tokens=int(rng.integers(1, 30))))
    kw.append(dict(uid=99, arrival=0.5))          # never finished
    got = metrics.summarize([metrics.RequestTiming(**k) for k in kw])
    want = jmetrics.summarize([jmetrics.RequestTiming(**k) for k in kw])
    assert got == want
    with pytest.raises(ValueError, match="no finished"):
        metrics.summarize([metrics.RequestTiming(uid=0, arrival=0.0)])


@pytest.mark.parametrize("engine", ["resident", "host"])
def test_replay_drives_either_engine(engine):
    cfg = CFG
    params = _params(cfg)
    sc = stream.StreamConfig(num_requests=6, vocab_size=cfg.vocab_size,
                             arrival="batch", prompt_lens=(4, 8),
                             new_low=2, new_high=6, seed=1)
    reqs = stream.make_requests(sc)
    if engine == "resident":
        backend = ResidentEngine(cfg, params, max_slots=2, max_len=32,
                                 chunk=3)
    else:
        backend = stream.HostBatcherDriver(ContinuousBatcher(
            cfg, params, max_slots=2, max_len=32))
    timings = stream.replay(backend, reqs)
    summary = metrics.summarize(timings)
    assert summary["requests"] == 6
    assert summary["tokens"] == sum(r.max_new_tokens for r in reqs)
    for r in reqs:
        assert len(backend.outputs[r.uid]) == r.max_new_tokens


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--stream", "--requests", "6"],
                                  ["--engine", "host", "--requests", "3",
                                   "--new", "4"]])
def test_launch_serve_on_the_cpu(argv):
    from repro_torch.launch import serve as launch_serve
    summary = launch_serve.main(["--arch", "h2o-danube-1.8b", "--device",
                                 "cpu"] + argv)
    assert summary["tokens"] > 0


def test_launch_serve_refuses_a_checkpoint_by_roadmap_item():
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        launch_serve.main(["--device", "cpu", "--ckpt-dir", "/nonexistent"])


def test_launch_serve_module_runs_as_a_script():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "2", "--new", "3"],
        capture_output=True, text=True, env=env, check=True).stdout
    assert "device=cpu" in out and "tok/s" in out


def test_tiny_config_compares_as_data_with_the_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JModelConfig(**TINY))
