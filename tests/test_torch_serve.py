"""The port's serving stack (``repro_torch.serve``) on the CPU: the resident
engine and the host batcher against each other, against standalone greedy
decode in the port, and against the JAX package's engine on the same
prompts and parameters (tokens and transfer ledger); the seeded streams and
their summaries against the reference's, bit for bit.

Greedy tokens are compared exactly: both packages compute the same float32
logits to ~1e-6 (tests/test_torch_models.py), and the models here are tiny,
so no argmax sits near a tie.  In the MoE models (jamba's among them) a
decode batch's rows share the experts' capacity, so the engine and the host
batcher are held to each other where both decode the same rows.  The SSM
models keep recurrent states in the cache, which no position masks: an
admission must overwrite all of its slot's row, and so must an
encoder-decoder's (the cross-attention K/V of the request's audio).
Requests with an image prefix or audio go through both engines and the
JAX engine; those whose row cache would not fit the shared one are refused
by name.
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
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.serve import metrics as jmetrics, stream as jstream
from repro.serve.engine import ResidentEngine as JResidentEngine
from repro.serve.scheduler import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import cuda_graphs
from repro_torch.models import multimodal, placed, transformer
from repro_torch.models.api import ModelConfig
from repro_torch.serve import engine as engine_mod, metrics, stream
from repro_torch.serve.engine import ResidentEngine
from repro_torch.serve.scheduler import ContinuousBatcher, Request, \
    cache_insert

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


# ---------------------------------------------------------------------------
# the chunk's CUDA graph: eager on the CPU, its logic with a stand-in capture
# ---------------------------------------------------------------------------

def test_the_cpu_engine_runs_its_chunks_eagerly():
    eng = _run_both(CFG, _params(CFG), _requests(CFG, 8), slots=3, chunk=4)
    assert eng.graphs == {"captures": 0, "replays": 0, "capture_s": 0.0}
    chunks = eng.transfers["chunks"]
    assert chunks > 0 and eng.transfers == {"h2d": 8, "d2h": chunks,
                                            "chunks": chunks}


def test_graphs_need_cuda_unplaced_params_and_the_greedy_sampler(
        monkeypatch):
    params = _params(CFG)
    cuda = torch.device("cuda", 0)           # a name: no card is needed
    greedy = engine_mod._greedy
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert engine_mod._use_graphs(cuda, params, greedy)
    assert not engine_mod._use_graphs(torch.device("cpu"), params, greedy)
    # params on a card that is not the current device
    assert not engine_mod._use_graphs(torch.device("cuda", 1), params,
                                      greedy)
    assert not engine_mod._use_graphs(cuda, params, _second_best)
    # a stand-in for params placed across ranks (DTensor leaves)
    monkeypatch.setattr(placed, "is_placed", lambda x: True)
    assert not engine_mod._use_graphs(cuda, params, greedy)


class CpuCapture(cuda_graphs.GraphCapture):
    """GraphCapture played on the CPU: the warm-up runs; a capture runs
    nothing (it records), and a replay runs what it recorded."""

    def _warm_up(self, fn):
        fn()

    def _capture(self, record):
        return record


def _graphed_engines(monkeypatch):
    """From here on, engines take the graph path with the CPU stand-in."""
    monkeypatch.setattr(engine_mod, "_use_graphs", lambda *a: True)
    monkeypatch.setattr(cuda_graphs, "GraphCapture", CpuCapture)


def _eos_of(cfg, params, reqs, slots, chunk):
    """A token an eager engine emits mid-way through its first output."""
    probe = ResidentEngine(cfg, params, max_slots=slots, max_len=40,
                           chunk=chunk)
    for r in reqs:
        probe.submit(r)
    out = probe.run_until_done()[reqs[0].uid]
    return int(out[len(out) // 2])


@pytest.mark.parametrize("arch", ["tiny", "h2o-danube-1.8b",
                                  "llama4-scout-17b-a16e", "xlstm-350m",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_a_graphed_engine_equals_the_eager_engine_and_the_host_batcher(
        arch, monkeypatch):
    """The graph path's own logic, its capture stood in for: the chunk
    reads and writes the engine's state in place (admissions between
    replays seen with no copy; positions, slot state and SSM states copied
    back), the warm-up runs on scratch copies (danube's window of 16 is a
    ring buffer that its prompts of 20 wrap: a warm-up on the live cache
    would overwrite entries the chunk still reads).  Eight requests of one
    budget through 4 slots (the MoE rows share capacity, so every path
    decodes the same rows), with an EOS that retires slots mid-chunk where
    no MoE couples the rows: the same tokens and ledger as the eager engine
    and the host batcher, one capture and a replay a chunk."""
    cfg = CFG if arch == "tiny" else \
        tconfigs.smoke_variant(tconfigs.get_config(arch))
    params = _params(cfg, seed=1)
    if cfg.encoder_layers > 0:
        reqs = _mm_requests(cfg, 8, seed=4, new=(6, 7))
    else:
        reqs = _requests(cfg, 8, seed=4, lens=(2, 5, 12, 20), new=(6, 7))
    eos = None if cfg.moe_experts else _eos_of(cfg, params, reqs, 4, 3)
    eager = _run_both(cfg, params, reqs, slots=4, max_len=40, chunk=3,
                      eos_id=eos)
    _graphed_engines(monkeypatch)
    graphed = _run_both(cfg, params, reqs, slots=4, max_len=40, chunk=3,
                        eos_id=eos)
    for uid in eager.outputs:
        np.testing.assert_array_equal(graphed.outputs[uid],
                                      eager.outputs[uid])
    assert cfg.moe_experts or any(len(o) < 6
                                  for o in graphed.outputs.values())
    assert graphed.transfers == eager.transfers
    assert graphed.graphs["captures"] == 1
    assert graphed.graphs["replays"] == graphed.transfers["chunks"]


def test_the_warm_up_leaves_the_engines_state_untouched(monkeypatch):
    """The warm-up chunk runs on scratch copies: the live slot state and
    cache are bit for bit what they were, the ring buffers of danube's
    windowed layers (16 positions, prompts of 20) among them, which a
    warm-up on the live cache would write ahead into."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    _graphed_engines(monkeypatch)
    eng = ResidentEngine(cfg, _params(cfg), max_slots=2, max_len=40,
                         chunk=3)
    for r in _requests(cfg, 2, seed=5, lens=(20,), new=(6, 7)):
        eng.submit(r)
    untouched = []

    def warm_up(self, fn):
        live = pytree.tree_leaves((eng.state, eng.cache))
        before = [t.clone() for t in live]
        fn()
        untouched.append(all(map(torch.equal, before, live)))

    monkeypatch.setattr(CpuCapture, "_warm_up", warm_up)
    eng.step()
    assert untouched == [True]
    assert eng.graphs["captures"] == eng.graphs["replays"] == 1


def test_a_capture_that_raises_leaves_the_engine_eager(monkeypatch):
    """A decode step that cannot be captured: the engine runs its chunks
    eagerly, gives the eager tokens, and its counter shows no capture."""
    reqs = _requests(CFG, 6, seed=2)
    want = _run_both(CFG, _params(CFG), reqs, slots=2, chunk=4).outputs
    _graphed_engines(monkeypatch)

    def refuses(self, record):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(CpuCapture, "_capture", refuses)
    with pytest.warns(UserWarning, match="runs eagerly"):
        eng = _run_both(CFG, _params(CFG), reqs, slots=2, chunk=4)
    for uid in want:
        np.testing.assert_array_equal(eng.outputs[uid], want[uid])
    assert eng.graphs == {"captures": 0, "replays": 0, "capture_s": 0.0}


# ---------------------------------------------------------------------------
# requests with an image prefix (llava) or audio (whisper)
# ---------------------------------------------------------------------------

MM_ARCHS = ["whisper-base", "llava-next-mistral-7b"]


def _mm_model(arch):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _modality(cfg, seed, frames=None) -> dict:
    """One request's stub input (no batch axis), as a Request carries it."""
    if cfg.frontend == "vision_stub":
        return {"image_embeds": multimodal.fake_image_patches(
            1, cfg.d_model, cfg.image_tokens, seed=seed)[0]}
    return {"audio_frames": multimodal.fake_audio_frames(
        1, cfg.d_model, frames or cfg.encoder_seq, seed=seed)[0]}


def _mm_requests(cfg, n, seed, cls=Request, lens=(3, 9, 14), new=(2, 8)):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                           size=int(rng.choice(lens)))
                .astype(np.int32), max_new_tokens=int(rng.integers(*new)),
                **_modality(cfg, seed + i))
            for i in range(n)]


@pytest.mark.parametrize("arch", MM_ARCHS)
def test_modality_engine_equals_host_batcher_and_the_jax_engine(arch):
    """Five requests, each with its own image or audio, through two slots:
    the port's engine, its host batcher and the JAX engine give the same
    tokens, and the engines the same transfer ledger (one upload an
    admission, modality or not)."""
    jcfg, tcfg, jp, tp = _mm_model(arch)
    treqs = _mm_requests(tcfg, 5, seed=3)
    jreqs = _mm_requests(tcfg, 5, seed=3, cls=JRequest)
    eng = _run_both(tcfg, tp, treqs, slots=2, max_len=48, chunk=3)
    jeng = JResidentEngine(jcfg, jp, max_slots=2, max_len=48, chunk=3)
    for r in jreqs:
        jeng.submit(r)
    jout = jeng.run_until_done()
    assert set(eng.outputs) == set(jout)
    for uid in jout:
        np.testing.assert_array_equal(eng.outputs[uid], jout[uid])
    assert eng.transfers == jeng.transfers
    assert eng.transfers["h2d"] == len(treqs)


def test_cache_insert_overwrites_a_slots_cross_kv():
    """A slot's cross K/V are the last admitted request's audio's: the
    splice overwrites them as it overwrites the KV rows, in the engine and
    in cache_insert alone (the other slots untouched)."""
    _, cfg, _, params = _mm_model("whisper-base")
    a, b = _mm_requests(cfg, 2, seed=8, new=(2, 3))
    eng = ResidentEngine(cfg, params, max_slots=1, max_len=32, chunk=2)
    eng.submit(a)
    eng.run_until_done()
    eng.submit(b)
    eng._admit_all()
    rows = {}
    for r in (a, b):
        _, rows[r.uid] = transformer.prefill(
            cfg, params, torch.from_numpy(r.tokens)[None], max_len=32,
            audio_frames=torch.from_numpy(r.audio_frames)[None])
    for got, want, old in zip(eng.cache["layers"], rows[b.uid]["layers"],
                              rows[a.uid]["layers"]):
        for name in ("k", "v"):
            assert torch.equal(got["cross"][name][0], want["cross"][name][0])
            assert not torch.equal(got["cross"][name][0],
                                   old["cross"][name][0])
    shared = transformer.init_cache(cfg, 3, 32, device="cpu")
    for leaf in pytree.tree_leaves(shared["layers"]):
        leaf.fill_(7.0)
    shared = cache_insert(shared, rows[b.uid], 1)
    for got, want in zip(shared["layers"], rows[b.uid]["layers"]):
        for name in ("k", "v"):
            assert torch.equal(got["cross"][name][1], want["cross"][name][0])
            assert bool((got["cross"][name][[0, 2]] == 7.0).all())


def _refused(engine, cfg, params, req, max_len, match):
    cls = ResidentEngine if engine == "resident" else ContinuousBatcher
    eng = cls(cfg, params, max_slots=1, max_len=max_len)
    eng.submit(req)
    with pytest.raises(ValueError, match=match):
        eng.step()


@pytest.mark.parametrize("engine", ["resident", "host"])
def test_oversize_image_prefix_is_refused_by_name(engine):
    """16 image tokens and a 6-token prompt take 22 cache positions: past
    max_len=20, although the prompt alone fits."""
    _, cfg, _, params = _mm_model("llava-next-mistral-7b")
    req = Request(uid=4, tokens=np.arange(6, dtype=np.int32),
                  **_modality(cfg, 0))
    _refused(engine, cfg, params, req, 20,
             "request 4: image prefix of 16 and prompt of 6 tokens take 22 "
             "cache positions, past max_len=20")


@pytest.mark.parametrize("frames", [20, 40])
@pytest.mark.parametrize("engine", ["resident", "host"])
def test_audio_of_another_length_is_refused_by_name(engine, frames):
    _, cfg, _, params = _mm_model("whisper-base")
    req = Request(uid=5, tokens=np.arange(4, dtype=np.int32),
                  **_modality(cfg, 0, frames=frames))
    _refused(engine, cfg, params, req, 32,
             f"request 5: audio of {frames} frames, but the cross-attention "
             f"cache holds encoder_seq=32")


def test_image_prefix_that_fills_max_len_is_admitted_as_the_reference():
    """prefix + prompt == max_len gives a row cache of the shared shape:
    the JAX engine admits it, and so does the port, with its tokens."""
    jcfg, tcfg, jp, tp = _mm_model("llava-next-mistral-7b")
    kw = _modality(tcfg, 2)
    toks = np.arange(8, dtype=np.int32)
    teng = ResidentEngine(tcfg, tp, max_slots=1, max_len=24, chunk=2)
    jeng = JResidentEngine(jcfg, jp, max_slots=1, max_len=24, chunk=2)
    teng.submit(Request(uid=0, tokens=toks, max_new_tokens=3, **kw))
    jeng.submit(JRequest(uid=0, tokens=toks, max_new_tokens=3, **kw))
    np.testing.assert_array_equal(teng.run_until_done()[0],
                                  jeng.run_until_done()[0])


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
    """--ckpt-dir serves a trainer checkpoint's consensus now (ROADMAP
    Queue 1 item 11 is done; tests/test_torch_consensus.py serves one): a
    directory without a checkpoint is what it refuses."""
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
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


# ---------------------------------------------------------------------------
# MoE models: a decode batch's rows share the experts' capacity
# ---------------------------------------------------------------------------

MOE_ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]


def _moe_models(arch):
    """Smoke variants at 4 layers (scout's fourth is global, NoPE),
    the JAX package's init carried across."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).scaled(
        num_layers=4)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).scaled(
        num_layers=4)
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _count_drops(monkeypatch):
    """Counts the tokens capacity drops in decode steps (batches of the
    slots) while the test runs."""
    from repro_torch.models import moe
    route, drops = moe.route, []

    def counted(params, spec, xt):
        out = route(params, spec, xt)
        if xt.shape[0] == 4:
            drops.append(int((~out[4]).sum()))
        return out

    monkeypatch.setattr(moe, "route", counted)
    return drops


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_equals_the_host_batcher_and_the_jax_engine(arch,
                                                               monkeypatch):
    """At 4 slots an expert has one slot a decode step (4 experts), so
    decode drops tokens and couples the rows.  Eight requests with one
    budget fill and empty the 4 slots together, so the engine and the host
    batcher decode the same rows (the reference engine's claim) and give
    the same tokens, and the JAX package's engine gives them too."""
    jcfg, tcfg, jp, tp = _moe_models(arch)
    kw = dict(lens=(5, 12, 20), new=(6, 7))
    jreqs = _requests(tcfg, 8, seed=8, cls=JRequest, **kw)
    treqs = _requests(tcfg, 8, seed=8, **kw)
    drops = _count_drops(monkeypatch)
    eng = _run_both(tcfg, tp, treqs, slots=4, max_len=40, chunk=3)
    assert sum(drops) > 0
    jeng = JResidentEngine(jcfg, jp, max_slots=4, max_len=40, chunk=3)
    for r in jreqs:
        jeng.submit(r)
    jout = jeng.run_until_done()
    for uid in jout:
        np.testing.assert_array_equal(eng.outputs[uid], jout[uid])
    assert eng.transfers == jeng.transfers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_equals_the_jax_engine_with_uneven_budgets(arch):
    """Budgets and prompts of all lengths: slots retire mid-chunk and keep
    decoding hidden rows that still take capacity, as in the reference's
    engine, so the two engines give the same tokens."""
    jcfg, tcfg, jp, tp = _moe_models(arch)
    kw = dict(lens=(5, 12, 20), new=(2, 9))
    jreqs = _requests(tcfg, 7, seed=9, cls=JRequest, **kw)
    treqs = _requests(tcfg, 7, seed=9, **kw)
    jeng = JResidentEngine(jcfg, jp, max_slots=4, max_len=40, chunk=4)
    teng = ResidentEngine(tcfg, tp, max_slots=4, max_len=40, chunk=4)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jout, tout = jeng.run_until_done(), teng.run_until_done()
    assert set(tout) == set(jout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid], jout[uid])


def test_bf16_moe_engine_equals_the_host_batcher():
    """maverick's smoke variant in bf16 through both paths: the bf16 cache,
    the cache splice and the sampler on bf16 activations."""
    cfg = tconfigs.smoke_variant(tconfigs.get_config(
        "llama4-maverick-400b-a17b")).scaled(param_dtype="bfloat16")
    params = _params(cfg, seed=3)
    eng = _run_both(cfg, params, _requests(cfg, 8, seed=10, new=(5, 6)),
                    slots=4, max_len=40, chunk=5)
    assert eng.cache["layers"][0]["kv"]["k"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the SSM models: recurrent states in the cache, which no position masks
# ---------------------------------------------------------------------------

SSM_ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]


def _ssm_models(arch):
    """Smoke variants (2 layers: xlstm's mLSTM then sLSTM block; jamba's
    attention + swiglu then Mamba + a 4-expert top-2 MoE), the JAX
    package's init carried across."""
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _jax_engine(jcfg, jp, **kw):
    """The reference's engine with its cache leaves in buffers of their
    own: its ``slstm_init_state`` returns one zero array for all four
    states, and the engine's donated admission refuses to donate a buffer
    twice (a fault of the reference, ROADMAP Queue 3)."""
    eng = JResidentEngine(jcfg, jp, **kw)
    eng.cache = jax.tree.map(jnp.copy, eng.cache)
    return eng


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_equals_the_host_batcher_and_the_jax_engine(arch):
    """Eight requests of one budget through 4 slots (jamba's MoE decode
    batch shares capacity, so both paths decode the same rows), prompts of
    2 (shorter than the conv state), 5, 12 and 20 tokens: the engine, the
    host batcher and the JAX package's engine give the same tokens and the
    engines the same ledger."""
    jcfg, tcfg, jp, tp = _ssm_models(arch)
    kw = dict(lens=(2, 5, 12, 20), new=(6, 7))
    jreqs = _requests(tcfg, 8, seed=8, cls=JRequest, **kw)
    treqs = _requests(tcfg, 8, seed=8, **kw)
    eng = _run_both(tcfg, tp, treqs, slots=4, max_len=40, chunk=3)
    jeng = _jax_engine(jcfg, jp, max_slots=4, max_len=40, chunk=3)
    for r in jreqs:
        jeng.submit(r)
    jout = jeng.run_until_done()
    for uid in jout:
        np.testing.assert_array_equal(eng.outputs[uid], jout[uid])
    assert eng.transfers == jeng.transfers


def test_xlstm_engine_equals_the_jax_engine_with_uneven_budgets():
    """Budgets and prompts of all lengths: slots retire mid-chunk and are
    refilled while the others decode on."""
    jcfg, tcfg, jp, tp = _ssm_models("xlstm-350m")
    kw = dict(lens=(1, 5, 12, 20), new=(2, 9))
    jreqs = _requests(tcfg, 7, seed=9, cls=JRequest, **kw)
    treqs = _requests(tcfg, 7, seed=9, **kw)
    teng = _run_both(tcfg, tp, treqs, slots=3, max_len=40, chunk=4)
    jeng = _jax_engine(jcfg, jp, max_slots=3, max_len=40, chunk=4)
    for r in jreqs:
        jeng.submit(r)
    jout = jeng.run_until_done()
    assert set(teng.outputs) == set(jout)
    for uid in jout:
        np.testing.assert_array_equal(teng.outputs[uid], jout[uid])
    assert teng.transfers == jeng.transfers


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_chunk_size_invariance(arch):
    _, tcfg, _, tp = _ssm_models(arch)
    reqs = _requests(tcfg, 6, seed=5, lens=(3, 9, 14), new=(5, 6))
    outs = {}
    for chunk in (1, 4, 16):
        eng = ResidentEngine(tcfg, tp, max_slots=3, max_len=32, chunk=chunk)
        for r in reqs:
            eng.submit(r)
        outs[chunk] = eng.run_until_done()
    for chunk in (4, 16):
        assert set(outs[1]) == set(outs[chunk])
        for uid in outs[1]:
            np.testing.assert_array_equal(outs[1][uid], outs[chunk][uid])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_admission_resets_every_recurrent_state_of_the_slot(arch):
    """A slot reused after a retirement: its row of every state leaf
    (conv, h; c, n, m; the sLSTM's c, n, h, m) is the new prompt's prefill
    state, whatever the retired request left there, and the request's
    tokens equal a fresh engine's.  A stale recurrent state, unlike a
    stale KV entry, is masked by no position."""
    _, tcfg, _, tp = _ssm_models(arch)
    first, second = _requests(tcfg, 2, seed=11, lens=(7, 13), new=(9, 10))
    eng = ResidentEngine(tcfg, tp, max_slots=1, max_len=32, chunk=4)
    eng.submit(first)
    while eng.busy:
        eng.step()
    before = [t.clone() for t in pytree.tree_leaves(eng.cache["layers"])]
    eng.submit(second)
    eng._admit_all()
    _, row = transformer.prefill(tcfg, tp,
                                 torch.from_numpy(second.tokens)[None],
                                 max_len=32)
    changed = 0
    for (key, got), want, old in zip(
            pytree.tree_flatten_with_path(eng.cache["layers"])[0],
            pytree.tree_leaves(row["layers"]), before):
        if "kv" in pytree.keystr(key):
            continue
        assert torch.equal(got[0], want[0].to(got.dtype)), key
        changed += int(not torch.equal(got, old))
    assert changed > 0
    while eng.busy:
        eng.step()
    fresh = ResidentEngine(tcfg, tp, max_slots=1, max_len=32, chunk=4)
    fresh.submit(second)
    np.testing.assert_array_equal(eng.outputs[second.uid],
                                  fresh.run_until_done()[second.uid])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_launch_serve_serves_the_ssm_smoke_variants_on_the_cpu(arch):
    from repro_torch.launch import serve as launch_serve
    summary = launch_serve.main(["--arch", arch, "--device", "cpu",
                                 "--requests", "3", "--new", "4"])
    assert summary["tokens"] == 12
