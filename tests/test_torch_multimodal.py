"""The port's encoder-decoder and image-prefix models (whisper-base,
llava-next-mistral-7b) against the JAX package's: the modality stubs
(``models.multimodal``) bit for bit, cross-attention
(``attention.cross_attention_cache`` / ``cross_attention_apply``,
``attention_forward`` with ``kv_src``), the parameter and cache trees, and
the smoke variants' forward, prefill, decode, loss and gradients on the
same parameters (drawn by the reference, carried across through numpy) and
the same numpy inputs.

Tolerances are those of ``tests/test_torch_models.py``: float32 per module
rtol 1e-5 / atol 1e-5, logits and gradients rtol 1e-4 / atol 1e-5.  The
kernel route runs the kernels' plain versions on the CPU; for llava it is
also held to the JAX package's Pallas flash and RMSNorm kernels in
interpret mode.  Prefill plus one decode step is held to the forward at
the next position at the reference's own atol 2e-4
(``tests/test_archs_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro import configs as jconfigs
from repro.models import attention as jattn, common as jcommon, \
    multimodal as jmm, transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import prox as tprox
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn, multimodal as tmm, \
    transformer as ttransformer
from repro_torch.train import steps as tsteps

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
EXACT_ATOL = 2e-4
ARCHS = ["whisper-base", "llava-next-mistral-7b"]
KERNELS = dict(use_flash=True, use_fused_norm=True)


def _close(got, want, tol=MODULE_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _carry(jtree):
    return params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")


def _model(arch, seed=0):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, _carry(jp)


def _modality(cfg, batch, seed=0) -> dict:
    """The config's stub input as numpy, the reference's smoke-test way."""
    if cfg.frontend == "vision_stub":
        return {"image_embeds": tmm.fake_image_patches(
            batch, cfg.d_model, cfg.image_tokens, seed=seed)}
    return {"audio_frames": tmm.fake_audio_frames(
        batch, cfg.d_model, cfg.encoder_seq, seed=seed)}


def _jkw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _tkw(kw):
    return {k: _t(v) for k, v in kw.items()}


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the stubs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,d,frames,seed", [
    (1, 128, 32, 0), (2, 512, None, 3), (3, 64, 7, 9)])
def test_fake_audio_frames_are_the_reference_bits(batch, d, frames, seed):
    kw = dict(seed=seed) if frames is None else dict(frames=frames,
                                                     seed=seed)
    got = tmm.fake_audio_frames(batch, d, **kw)
    want = jmm.fake_audio_frames(batch, d, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch,d,tokens,seed", [
    (1, 128, 16, 0), (2, 64, None, 5), (1, 4096, 1152, 1)])
def test_fake_image_patches_are_the_reference_bits(batch, d, tokens, seed):
    got = tmm.fake_image_patches(batch, d, tokens, seed=seed)
    want = jmm.fake_image_patches(batch, d, tokens, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_multimodal_constants_match():
    assert tmm.__all__ == jmm.__all__
    for name in ("WHISPER_FRAMES", "LLAVA_TILES", "LLAVA_PATCHES_PER_TILE"):
        assert getattr(tmm, name) == getattr(jmm, name), name
    for tiles in range(1, 6):
        assert tmm.llava_image_tokens(tiles) == jmm.llava_image_tokens(tiles)
    assert tmm.llava_image_tokens() == jmm.llava_image_tokens() == 1152


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def _cross_specs(heads, kv, **over):
    kw = dict(d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
              cross=True, causal=False, **over)
    return jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)


@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (8, 1)])
def test_cross_attention_cache_and_apply_match(heads, kv):
    jspec, tspec = _cross_specs(heads, kv)
    jp = jattn.init_attention(jcommon.KeyGen(jax.random.PRNGKey(heads)),
                              jspec)
    tp = _carry(jp)
    rng = np.random.default_rng(heads * 10 + kv)
    enc = rng.normal(size=(2, 23, 64)).astype(np.float32)
    jc = jattn.cross_attention_cache(jp, jspec, jnp.asarray(enc))
    tc = tattn.cross_attention_cache(tp, tspec, _t(enc))
    assert set(tc) == set(jc) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == (2, 23, kv, 16)
        _close(tc[name], jc[name])
    for s in (1, 9):     # a decode step and a prompt
        x = rng.normal(size=(2, s, 64)).astype(np.float32)
        _close(tattn.cross_attention_apply(tp, tspec, _t(x), tc),
               jattn.cross_attention_apply(jp, jspec, jnp.asarray(x), jc))


@pytest.mark.parametrize("over", [dict(), dict(cross=True, causal=False),
                                  dict(causal=False, use_rope=False),
                                  dict(use_flash=True)],
                         ids=["causal_rope", "cross", "bidirectional_nope",
                              "flash_spec"])
def test_attention_forward_with_kv_src_matches(over):
    """kv_src from another sequence (longer than x): the keys and values
    project it; RoPE applies unless the layer is cross-attention, and the
    flash route never takes a kv_src."""
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, **over)
    jspec, tspec = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    jp = jattn.init_attention(jcommon.KeyGen(jax.random.PRNGKey(5)), jspec)
    tp = _carry(jp)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    src = rng.normal(size=(2, 12, 64)).astype(np.float32)
    _close(tattn.attention_forward(tp, tspec, _t(x), kv_src=_t(src)),
           jattn.attention_forward(jp, jspec, jnp.asarray(x),
                                   kv_src=jnp.asarray(src)))


def test_cross_attention_decode_spec_takes_no_rope_and_no_causal_mask():
    """attention_decode with a cross spec, as the reference computes it:
    no RoPE on the new query and key, no causal mask over the cache."""
    jspec, tspec = _cross_specs(4, 2)
    jp = jattn.init_attention(jcommon.KeyGen(jax.random.PRNGKey(3)), jspec)
    tp = _carry(jp)
    rng = np.random.default_rng(4)
    jc = jattn.init_kv_cache(2, 16, jspec)
    jc = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
          for k, v in jc.items()}
    tc = _carry(jc)
    xs = rng.normal(size=(2, 1, 64)).astype(np.float32)
    pos = np.array([3, 11], np.int32)
    jo, jc = jattn.attention_decode(jp, jspec, jnp.asarray(xs), jc,
                                    jnp.asarray(pos))
    to, tc = tattn.attention_decode(tp, tspec, _t(xs), tc, _t(pos))
    _close(to, jo)
    _close(tc["k"], jc["k"])


# ---------------------------------------------------------------------------
# the models' trees
# ---------------------------------------------------------------------------

def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    jcfg, tcfg, jp, _ = _model(arch)
    tp = ttransformer.init_params(tcfg, 0, device="cpu")
    assert _shapes(params_to_numpy(tp)) == _shapes(jp)
    assert ttransformer.param_count(tp) == jtransformer.param_count(jp)
    # the reference's key order in each block: cross after post_norm1,
    # before norm2
    assert list(tp["layers"][0]) == list(jp["layers"][0])
    if tcfg.encoder_layers:
        assert set(tp["encoder"]) == {"layers", "final_norm", "pos_embed"}
        assert len(tp["encoder"]["layers"]) == tcfg.encoder_layers
        assert tuple(tp["encoder"]["pos_embed"].shape) == \
            (tcfg.encoder_seq, tcfg.d_model)
        assert "cross" not in tp["encoder"]["layers"][0]
    else:
        assert tuple(tp["vision_proj"].shape) == (tcfg.d_model, tcfg.d_model)
    again = ttransformer.init_params(tcfg, 0, device="cpu")
    for a, b in zip(jax.tree.leaves(params_to_numpy(again)),
                    jax.tree.leaves(params_to_numpy(tp))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch,max_len", [(1, 8), (3, 40)])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_has_the_reference_layout(arch, batch, max_len):
    jcfg, tcfg, _, _ = _model(arch)
    jc = jtransformer.init_cache(jcfg, batch, max_len)
    tc = ttransformer.init_cache(tcfg, batch, max_len, device="cpu")
    assert _shapes(params_to_numpy(tc)) == _shapes(jc)
    for te, je in zip(tc["layers"], jc["layers"]):
        assert list(te) == list(je)
    leaves = pytree.tree_leaves(tc)
    assert len({t.data_ptr() for t in leaves}) == len(leaves)


# ---------------------------------------------------------------------------
# forward, prefill, decode, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [dict(), KERNELS], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_logits_match(arch, flags):
    jcfg, tcfg, jp, tp = _model(arch)
    tcfg = tcfg.scaled(**flags)
    toks = _tokens(jcfg, (2, 20), 0)
    kw = _modality(jcfg, 2, seed=1)
    jl, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks), **_jkw(kw))
    tl, aux = ttransformer.forward(tcfg, tp, _t(toks), **_tkw(kw))
    assert tuple(tl.shape) == (2, 20, tcfg.vocab_size)
    _close(tl, jl, LOGIT_TOL)
    assert float(aux) == 0.0
    jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=48,
                                  **_jkw(kw))
    tl, tc = ttransformer.prefill(tcfg, tp, _t(toks), max_len=48, **_tkw(kw))
    _close(tl, jl, LOGIT_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for te, je in zip(tc["layers"], jc["layers"]):
        _close(te["kv"]["k"], je["kv"]["k"])
        if "cross" in je:
            _close(te["cross"]["k"], je["cross"]["k"])
            _close(te["cross"]["v"], je["cross"]["v"])
    cross_before = [e["cross"]["k"].clone() for e in tc["layers"]
                    if "cross" in e]
    cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jtransformer.decode_step(jcfg, jp, jc, jnp.asarray(cur))
        tl, tc = ttransformer.decode_step(tcfg, tp, tc, _t(cur))
        _close(tl, jl, LOGIT_TOL)
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    # decode reads the cross K/V and never writes them
    for before, e in zip(cross_before, [e for e in tc["layers"]
                                        if "cross" in e]):
        assert torch.equal(before, e["cross"]["k"])


def test_llava_kernel_routes_match_the_jax_kernels_in_interpret_mode():
    """The JAX package's Pallas flash and RMSNorm kernels (interpret mode)
    over the image prefix and the prompt, against the port's routes through
    its kernels' CPU versions."""
    jcfg, tcfg, jp, tp = _model("llava-next-mistral-7b")
    toks = _tokens(jcfg, (1, 24), 2)
    kw = _modality(jcfg, 1, seed=2)
    jl, _ = jtransformer.forward(jcfg.scaled(**KERNELS), jp,
                                 jnp.asarray(toks), **_jkw(kw))
    tl, _ = ttransformer.forward(tcfg.scaled(**KERNELS), tp, _t(toks),
                                 **_tkw(kw))
    _close(tl, jl, LOGIT_TOL)
    jl, _ = jtransformer.prefill(jcfg.scaled(**KERNELS), jp,
                                 jnp.asarray(toks), max_len=48, **_jkw(kw))
    tl, _ = ttransformer.prefill(tcfg.scaled(**KERNELS), tp, _t(toks),
                                 max_len=48, **_tkw(kw))
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_routes_only_the_decoders_causal_self_attention(arch,
                                                              monkeypatch):
    """One flash call a decoder layer; whisper's encoder (bidirectional)
    and its cross-attention take the plain path, by the reference's rule."""
    _, tcfg, _, tp = _model(arch)
    calls = []
    real = fa_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    toks = _tokens(tcfg, (1, 10), 3)
    ttransformer.prefill(tcfg.scaled(**KERNELS), tp, _t(toks), max_len=32,
                         **_tkw(_modality(tcfg, 1)))
    prefix = tcfg.image_tokens if tcfg.frontend == "vision_stub" else 0
    assert calls == [((1, 10 + prefix, tcfg.num_heads, tcfg.hd),
                      (1, 10 + prefix, tcfg.num_kv_heads, tcfg.hd), True)
                     ] * tcfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 16)).astype(np.int32),
             **_modality(jcfg, 2, seed=4)}
    jloss, jgrad = jax.value_and_grad(jtransformer.loss_fn(jcfg))(
        jp, _jkw(batch))
    tgrad, tloss = torch.func.grad_and_value(ttransformer.loss_fn(tcfg))(
        tp, _tkw(batch))
    _close(tloss, jloss, LOGIT_TOL)
    tleaves = jax.tree.leaves(params_to_numpy(tgrad))
    jleaves = jax.tree.leaves(jgrad)
    assert len(tleaves) == len(jleaves)
    for tg, jg in zip(tleaves, jleaves):
        _close(tg, jg, LOGIT_TOL)
    # the modality's own weights get gradient
    key = "encoder" if jcfg.encoder_layers else "vision_proj"
    assert float(np.abs(jax.tree.leaves(params_to_numpy(tgrad[key]))[0])
                 .max()) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_the_forward(arch):
    """The reference's test_smoke_prefill_decode_exactness, through the
    port: the prefill's last logits and one decode step equal the forward
    at positions L - 1 and L."""
    _, tcfg, _, tp = _model(arch)
    toks = torch.as_tensor(_tokens(tcfg, (2, 16), 0))
    kw = _tkw(_modality(tcfg, 2))
    logits, cache = ttransformer.prefill(tcfg, tp, toks, **kw)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    step, _ = ttransformer.decode_step(tcfg, tp, cache, nxt)
    full, _ = ttransformer.forward(
        tcfg, tp, torch.cat([toks, nxt[:, None]], 1), **kw)
    np.testing.assert_allclose(full[:, 15].numpy(), logits.numpy(),
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(full[:, 16].numpy(), step.numpy(),
                               atol=EXACT_ATOL)


def _greedy(cfg, params, toks, n_new, **kw):
    logits, cache = ttransformer.prefill(
        cfg, params, toks, max_len=toks.shape[1] + n_new + 8, **kw)
    outs = []
    cur = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(n_new):
        outs.append(cur)
        logits, cache = ttransformer.decode_step(cfg, params, cache, cur)
        cur = torch.argmax(logits, -1).to(torch.int32)
    return torch.stack(outs, 1)


def test_whisper_decoder_depends_on_its_audio():
    """The reference's test_whisper_conditioned_decode, through the port,
    and its tokens equal the reference's for each audio."""
    jcfg, tcfg, jp, tp = _model("whisper-base", seed=1)
    toks = _tokens(tcfg, (2, 8), 1)
    gens = []
    for seed in (0, 9):
        f = tmm.fake_audio_frames(2, tcfg.d_model, tcfg.encoder_seq,
                                  seed=seed)
        got = _greedy(tcfg, tp, _t(toks), 4, audio_frames=_t(f))
        jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=20,
                                      audio_frames=jnp.asarray(f))
        want = []
        cur = jnp.argmax(jl, -1).astype(jnp.int32)
        for _ in range(4):
            want.append(np.asarray(cur))
            jl, jc = jtransformer.decode_step(jcfg, jp, jc, cur)
            cur = jnp.argmax(jl, -1).astype(jnp.int32)
        np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
        gens.append(got)
    assert not torch.equal(gens[0], gens[1]), "decoder ignores the encoder"


@pytest.mark.parametrize("entry", ["forward", "prefill"])
def test_encoder_config_without_audio_raises(entry):
    _, tcfg, _, tp = _model("whisper-base")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="requires audio_frames"):
        getattr(ttransformer, entry)(tcfg, tp, toks)


def test_image_prefix_counts_in_positions_and_max_len():
    """max_len counts every cache position (image prefix included): a
    max_len below prefix + L grows to it, and decode starts at prefix + L
    (the reference's prefill)."""
    jcfg, tcfg, jp, tp = _model("llava-next-mistral-7b")
    toks = _tokens(tcfg, (1, 6), 5)
    kw = _modality(tcfg, 1, seed=5)
    prefix = tcfg.image_tokens
    for max_len in (prefix + 4, prefix + 6, prefix + 30):
        jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks),
                                      max_len=max_len, **_jkw(kw))
        tl, tc = ttransformer.prefill(tcfg, tp, _t(toks), max_len=max_len,
                                      **_tkw(kw))
        assert int(tc["pos"][0]) == int(jc["pos"][0]) == prefix + 6
        assert _shapes(params_to_numpy(tc)) == _shapes(jc)
        assert tc["layers"][0]["kv"]["k"].shape[1] == max(max_len,
                                                          prefix + 6)
        _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_bundle_and_loss_bundle_take_the_modalities(arch):
    """train/steps.py runs unchanged: the serve bundle's prefill_step
    forwards image_embeds / audio_frames, and the train bundle's loss_fn
    differentiates over a batch that carries them."""
    jcfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(tcfg, (2, 10), 6)
    kw = _modality(tcfg, 2, seed=6)
    bundle = tsteps.build_serve_steps(tcfg)
    tl, tc = bundle.prefill_step(tp, _t(toks), max_len=40, **_tkw(kw))
    jl, _ = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=40,
                                 **_jkw(kw))
    _close(tl, jl, LOGIT_TOL)
    cur = torch.argmax(tl, -1).to(torch.int32)
    dl, _ = bundle.decode_step(tp, tc, cur)
    assert bool(torch.isfinite(dl).all())
    loss = tsteps.build_train_step(tcfg, tprox.l1(1e-6), m=2).loss_fn
    batch = {"tokens": toks, "labels": _tokens(tcfg, (2, 10), 7), **kw}
    g = torch.func.grad(loss)(tp, _tkw(batch))
    jg = jax.grad(jtransformer.loss_fn(jcfg))(jp, _jkw(batch))
    for a, b in zip(jax.tree.leaves(params_to_numpy(g)), jax.tree.leaves(jg)):
        _close(a, b, LOGIT_TOL)


def test_configs_carry_the_modality_fields():
    for arch in ARCHS:
        t = tconfigs.get_config(arch)
        j = jconfigs.get_config(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    w = tconfigs.get_config("whisper-base")
    assert (w.encoder_layers, w.encoder_seq, w.frontend) == \
        (6, tmm.WHISPER_FRAMES, "audio_stub")
    lv = tconfigs.get_config("llava-next-mistral-7b")
    assert (lv.frontend, lv.image_tokens) == ("vision_stub", 1152)
    s = tconfigs.smoke_variant(w)
    assert (s.encoder_layers, s.encoder_seq) == (2, 32)
    assert tconfigs.smoke_variant(lv).image_tokens == 16
