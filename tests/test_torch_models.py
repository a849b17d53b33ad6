"""The port's dense decoder LMs (``repro_torch.models``) against the JAX
package's (``repro.models``): the same numpy inputs and the same parameters
(JAX-initialized, carried across by ``convert.params_from_numpy``) through
both, module by module and for the whole model.

Tolerances: float32 per module rtol 1e-5 / atol 1e-5; logits rtol 1e-4 /
atol 1e-5, as the reference's own flash-routing test uses
(tests/test_models.py): the same float32 formulas, summed in other orders
by XLA and ATen.  The JAX side runs its plain path (the reference's oracle
for its Pallas kernels) except where a test says it runs a Pallas kernel in
interpret mode, as the reference's tests do.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi, attention as jattn, \
    common as jcommon, ffn as jffn, transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as tapi, attention as tattn, \
    common as tcommon, ffn as tffn, transformer as ttransformer

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
DENSE_ARCHS = ["h2o-danube-1.8b", "minicpm-2b", "gemma2-9b"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=MODULE_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, _np(want), **tol)


def _jax_params(cfg, seed=0):
    return jtransformer.init_params(cfg, jax.random.PRNGKey(seed))


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# configs and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_configs_compare_as_data(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    js, ts = jconfigs.smoke_variant(j), tconfigs.smoke_variant(t)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.hd == js.hd
    for jp, tp in zip(japi.layer_plan(js), tapi.layer_plan(ts)):
        assert (tp.mixer, tp.ffn) == (jp.mixer, jp.ffn)
        assert dataclasses.asdict(tp.attn) == dataclasses.asdict(jp.attn)


def test_input_shapes_and_applicability_match():
    assert {k: dataclasses.asdict(v) for k, v in
            tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in DENSE_ARCHS:
        for shape in jconfigs.INPUT_SHAPES.values():
            tshape = tconfigs.INPUT_SHAPES[shape.name]
            assert tconfigs.shape_applicable(tconfigs.get_config(arch),
                                             tshape) == \
                jconfigs.shape_applicable(jconfigs.get_config(arch), shape)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-base",
                                  "xlstm-350m", "llama4-scout-17b-a16e",
                                  "stablelm-12b", "llava-next-mistral-7b"])
def test_unported_archs_raise_by_name(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tconfigs.get_config(arch)


@pytest.mark.parametrize("override,match", [
    (dict(mixer_pattern=("attn", "mamba")), "SSM"),
    (dict(moe_experts=4, moe_period=1), "MoE"),
    (dict(encoder_layers=2), "encoder"),
    (dict(frontend="vision_stub"), "encoder"),
    (dict(attn_shard_constraint=("data", "model")), "Queue 1 item 14"),
])
def test_unported_plans_raise_by_name(override, match):
    cfg = tconfigs.smoke_variant(tconfigs.get_config("h2o-danube-1.8b"))
    with pytest.raises(NotImplementedError, match=match):
        tapi.layer_plan(cfg.scaled(**override))


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_norms_softcap_and_gelu_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    _close(tcommon.rms_norm(_t(x), _t(w)), jcommon.rms_norm(x, w))
    _close(tcommon.layer_norm(_t(x), _t(w), _t(b)),
           jcommon.layer_norm(x, w, b))
    _close(tcommon.softcap(_t(10 * x), 30.0), jcommon.softcap(10 * x, 30.0))
    assert tcommon.softcap(_t(x), None) is not None
    _close(tcommon.gelu(_t(x)), jax.nn.gelu(x))


@pytest.mark.parametrize("head_dim,theta", [(32, 10000.0), (80, 10000.0),
                                            (64, 500000.0)])
def test_rope_matches(head_dim, theta):
    rng = np.random.default_rng(head_dim)
    pos = np.arange(37, dtype=np.int32)
    jc, js = jcommon.rope_angles(jnp.asarray(pos), head_dim, theta)
    tc, ts = tcommon.rope_angles(_t(pos), head_dim, theta)
    _close(tc, jc)
    _close(ts, js)
    x = rng.normal(size=(2, 37, 3, head_dim)).astype(np.float32)
    _close(tcommon.apply_rope(_t(x), tc, ts),
           jcommon.apply_rope(x, jc, js))


def test_initializers_follow_the_reference_distributions():
    gen = tcommon.make_generator(0, "cpu")
    w = tcommon.dense_init(gen, (512, 256))
    std = 1.0 / np.sqrt(512)
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    # N(0, 1) cut to [-2, 2] has standard deviation 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    e = tcommon.embed_init(gen, 1000, 64)
    assert abs(float(e.std()) * 8.0 - 1.0) < 0.02
    s = tcommon.dense_init(gen, (4096, 16), scale=0.02)
    assert abs(float(s.std()) / 0.02 - 0.8796) < 0.02


# ---------------------------------------------------------------------------
# ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches(kind):
    jp = jffn.init_ffn(jcommon.KeyGen(jax.random.PRNGKey(1)), 64, 128, kind)
    x = np.random.default_rng(1).normal(size=(2, 7, 64)).astype(np.float32)
    _close(tffn.ffn_forward(_carry(jp), _t(x), kind),
           jffn.ffn_forward(jp, x, kind))
    tp = tffn.init_ffn(tcommon.make_generator(0, "cpu"), 64, 128, kind)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# attention: forward, prefill, decode
# ---------------------------------------------------------------------------

SPECS = {
    "causal_gqa": dict(num_heads=4, num_kv_heads=2),
    "window": dict(num_heads=4, num_kv_heads=2, sliding_window=8),
    "softcap_mha": dict(num_heads=4, num_kv_heads=4, softcap=20.0),
    "chunked": dict(num_heads=4, num_kv_heads=1, chunk=8),
    "bidirectional": dict(num_heads=2, num_kv_heads=2, causal=False),
    "flash_window": dict(num_heads=4, num_kv_heads=2, sliding_window=8,
                         use_flash=True),
    "flash_softcap": dict(num_heads=4, num_kv_heads=1, softcap=20.0,
                          use_flash=True),
    "qk_norm": dict(num_heads=4, num_kv_heads=2, qk_norm=True),
}


def _specs(name):
    kw = dict(d_model=64, head_dim=16, **SPECS[name])
    return jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)


def _attn_params(jspec, seed=2):
    jp = jattn.init_attention(jcommon.KeyGen(jax.random.PRNGKey(seed)), jspec)
    if jspec.qk_norm:
        rng = np.random.default_rng(seed)
        jp["q_norm"] = jnp.asarray(0.1 * rng.normal(size=(16,)), jnp.float32)
        jp["k_norm"] = jnp.asarray(0.1 * rng.normal(size=(16,)), jnp.float32)
    return jp, _carry(jp)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_attention_forward_matches(name):
    jspec, tspec = _specs(name)
    jp, tp = _attn_params(jspec)
    x = np.random.default_rng(3).normal(size=(2, 20, 64)).astype(np.float32)
    _close(tattn.attention_forward(tp, tspec, _t(x)),
           jattn.attention_forward(jp, jspec, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["causal_gqa", "window", "chunked",
                                  "flash_softcap"])
@pytest.mark.parametrize("prompt", [5, 13, 24])
def test_attention_prefill_and_decode_match(name, prompt):
    """Prompts shorter and longer than the window/chunk of 8: the longer
    ones take the ring buffer's roll in prefill."""
    jspec, tspec = _specs(name)
    jp, tp = _attn_params(jspec)
    rng = np.random.default_rng(prompt)
    x = rng.normal(size=(2, prompt, 64)).astype(np.float32)
    jo, jc = jattn.attention_prefill(jp, jspec, jnp.asarray(x), max_len=32)
    to, tc = tattn.attention_prefill(tp, tspec, _t(x), max_len=32)
    _close(to, jo)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    pos = np.array([prompt, prompt], np.int32)
    for step in range(4):
        xs = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jc = jattn.attention_decode(jp, jspec, jnp.asarray(xs), jc,
                                        jnp.asarray(pos))
        to, tc = tattn.attention_decode(tp, tspec, _t(xs), tc, _t(pos))
        _close(to, jo)
        _close(tc["k"], jc["k"])
        pos = pos + 1


def test_attention_decode_rows_at_their_own_positions():
    jspec, tspec = _specs("window")
    jp, tp = _attn_params(jspec)
    rng = np.random.default_rng(9)
    jc = jattn.init_kv_cache(3, 16, jspec)
    jc = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
          for k, v in jc.items()}
    tc = params_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    xs = rng.normal(size=(3, 1, 64)).astype(np.float32)
    pos = np.array([0, 7, 30], np.int32)
    jo, _ = jattn.attention_decode(jp, jspec, jnp.asarray(xs), jc,
                                   jnp.asarray(pos))
    to, _ = tattn.attention_decode(tp, tspec, _t(xs), tc, _t(pos))
    _close(to, jo)


def test_flash_routing_rule_is_the_reference_rule():
    kw = dict(d_model=16, num_heads=2, num_kv_heads=2, head_dim=8,
              use_flash=True)
    for over in (dict(), dict(chunk=8), dict(cross=True),
                 dict(causal=False), dict(use_flash=False)):
        j = jattn.AttnSpec(**dict(kw, **over))
        t = tattn.AttnSpec(**dict(kw, **over))
        assert tattn._flash_ok(t, None, None) == jattn._flash_ok(j, None, None)
    t = tattn.AttnSpec(**kw)
    assert not tattn._flash_ok(t, torch.zeros(1, 4, 16), None)
    assert not tattn._flash_ok(t, None, torch.arange(4))


def test_cross_attention_waits_for_its_slice():
    _, tspec = _specs("causal_gqa")
    _, tp = _attn_params(_specs("causal_gqa")[0])
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tattn.attention_forward(tp, tspec, torch.zeros(1, 4, 64),
                                kv_src=torch.zeros(1, 4, 64))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _model(arch):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch))
    jp = _jax_params(jcfg)
    return jcfg, tcfg, jp, _carry(jp)


@pytest.mark.parametrize("flags", [dict(),
                                   dict(use_flash=True, use_fused_norm=True)],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_prefill_decode_logits_match(arch, flags):
    """Prompt of 24 tokens, longer than the smoke window of 16 (h2o-danube,
    gemma2's local layers): prefill rolls the ring buffer, decode wraps."""
    jcfg, tcfg, jp, tp = _model(arch)
    tcfg = tcfg.scaled(**flags)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    jl, _ = jtransformer.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = ttransformer.forward(tcfg, tp, _t(toks))
    _close(tl, jl, LOGIT_TOL)
    assert float(aux) == 0.0
    jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=40)
    tl, tc = ttransformer.prefill(tcfg, tp, _t(toks), max_len=40)
    _close(tl, jl, LOGIT_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), _np(jc["pos"]))
    cur = np.argmax(_np(jl), -1).astype(np.int32)
    for _ in range(3):
        jl, jc = jtransformer.decode_step(jcfg, jp, jc, jnp.asarray(cur))
        tl, tc = ttransformer.decode_step(tcfg, tp, tc, _t(cur))
        _close(tl, jl, LOGIT_TOL)
        cur = np.argmax(_np(jl), -1).astype(np.int32)
    np.testing.assert_array_equal(tc["pos"].numpy(), _np(jc["pos"]))


def test_kernel_routes_match_the_jax_kernels_in_interpret_mode():
    """The JAX package's Pallas flash and RMSNorm kernels (interpret mode)
    against the port's routes through its own kernels' CPU versions."""
    jcfg, tcfg, jp, tp = _model("h2o-danube-1.8b")
    flags = dict(use_flash=True, use_fused_norm=True)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (1, 32)).astype(np.int32)
    jl, _ = jtransformer.forward(jcfg.scaled(**flags), jp, jnp.asarray(toks))
    tl, _ = ttransformer.forward(tcfg.scaled(**flags), tp, _t(toks))
    _close(tl, jl, LOGIT_TOL)


def test_untied_head_and_learned_positions_match():
    """Paths no dense config of the port sets: an untied head and learned
    position embeddings (use_rope=False)."""
    over = dict(tie_embeddings=False, use_rope=False, max_position=64)
    jcfg = jconfigs.smoke_variant(jconfigs.get_config("minicpm-2b")).scaled(
        **over)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("minicpm-2b")).scaled(
        **over)
    jp = _jax_params(jcfg, seed=3)
    tp = _carry(jp)
    assert "lm_head" in tp and "pos_embed" in tp
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    _close(ttransformer.forward(tcfg, tp, _t(toks))[0],
           jtransformer.forward(jcfg, jp, jnp.asarray(toks))[0], LOGIT_TOL)
    jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=20)
    tl, tc = ttransformer.prefill(tcfg, tp, _t(toks), max_len=20)
    cur = np.argmax(_np(jl), -1).astype(np.int32)
    jl, _ = jtransformer.decode_step(jcfg, jp, jc, jnp.asarray(cur))
    tl, _ = ttransformer.decode_step(tcfg, tp, tc, _t(cur))
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_matches(arch):
    jcfg, tcfg, jp, tp = _model(arch)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, 512, (2, 16)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 16)).astype(np.int32)}
    jl = jtransformer.loss_fn(jcfg)(jp, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    tl = ttransformer.loss_fn(tcfg)(tp, {k: _t(v) for k, v in batch.items()})
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_has_the_reference_tree(arch):
    jcfg, tcfg, jp, _ = _model(arch)
    tp = ttransformer.init_params(tcfg, 0, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                           params_to_numpy(tp))
    assert tshapes == jshapes
    assert ttransformer.param_count(tp) == jtransformer.param_count(jp)
    # a seed gives the same parameters; another seed others
    again = ttransformer.init_params(tcfg, 0, device="cpu")
    assert torch.equal(again["layers"][1]["attn"]["wq"],
                       tp["layers"][1]["attn"]["wq"])
    other = ttransformer.init_params(tcfg, 1, device="cpu")
    assert not torch.equal(other["embed"], tp["embed"])


def test_cache_layout_matches():
    for arch in DENSE_ARCHS:
        jcfg, tcfg, _, _ = _model(arch)
        jc = jtransformer.init_cache(jcfg, 3, 40)
        tc = ttransformer.init_cache(tcfg, 3, 40, device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), jc) == \
            jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(tc))
