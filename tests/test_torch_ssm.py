"""The port's SSM mixers (``repro_torch.models.ssm``: Mamba, mLSTM, sLSTM)
against the JAX package's (``repro.models.ssm``): the same numpy inputs
and the same parameters (the reference initializes them,
``convert.params_from_numpy`` carries them across) through both, for the
full-sequence forward, ``init_state`` + ``step`` token by token, and the
prefill helpers' final states (``transformer._{mamba,mlstm,slstm}_prefill``),
at prompt lengths 1, 2 (shorter than the conv's 3 positions of state), 5,
24 and 32, in float32 and bf16.

Tolerances.  Mamba and sLSTM: float32 rtol 1e-5 / atol 1e-5 (the module
tolerance of tests/test_torch_models.py); bf16 within 2^-5 of the largest
|y| (tests/test_torch_moe.py's: each framework rounds to bf16 after its own
float32 sums).  The mLSTM's normalizer max(|n.q|, exp(-m)) has a pole
wherever n.q crosses 0, and exp(-m) shrinks like exp(-3 t) at the
reference's forget-gate init, so its float32 output is ill-conditioned: the
reference's own float32 result and the port's each lie about 1e-5 from
the same formula evaluated in float64, independently.  So the mLSTM is held
to the reference's own code run in float64
(``_torch_parity.reference_in_float64``): the port's float32 (bf16) result
may lie at most twice as far from it as the reference's float32 (bf16)
result does, plus atol 1e-5 (one bf16 ulp of the largest |y|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon, ssm as jssm, \
    transformer as jtransformer
from _torch_parity import assert_as_accurate_as_the_reference, \
    reference_float64
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as tcommon, ssm as tssm, \
    transformer as ttransformer

torch.set_num_threads(1)

D = 64
KINDS = ["mamba", "mlstm", "slstm"]
LENGTHS = [1, 2, 5, 24, 32]
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL_OF_MAX = 2.0 ** -5
# the ill-conditioned mLSTM: the port's distance to the float64 evaluation
# of the reference's code, at most this many times the reference's own
ANCHOR_FACTOR = 2.0
ANCHOR_ATOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _specs(kind):
    kw = {"mamba": dict(d_model=D, chunk_size=16),
          "mlstm": dict(d_model=D, num_heads=4),
          "slstm": dict(d_model=D, num_heads=4)}[kind]
    name = {"mamba": "MambaSpec", "mlstm": "MLstmSpec",
            "slstm": "SLstmSpec"}[kind]
    return getattr(jssm, name)(**kw), getattr(tssm, name)(**kw)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _params(kind, dtype="float32", seed=1):
    """(reference params in ``dtype``, their float32 values as numpy, the
    port's params in ``dtype``): bf16 values carried as their exact float32
    values, numpy having no bf16 that torch takes."""
    jspec, _ = _specs(kind)
    jp = getattr(jssm, f"init_{kind}")(
        jcommon.KeyGen(jax.random.PRNGKey(seed)), jspec, jnp.dtype(dtype))
    npp = _np32(jp)
    tp = {k: v.to(getattr(torch, dtype))
          for k, v in params_from_numpy(npp, "cpu").items()}
    return jp, npp, tp


def _x(shape, dtype, seed=0):
    """An input exact in ``dtype``, as float32 numpy."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, copy=True)).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _held(kind, dtype, got, want, want64=None):
    """``got`` (the port) against ``want`` (the reference) as the module
    docstring says; ``want64`` is the reference's float64 result, which the
    mLSTM is held to."""
    if kind == "mlstm":
        scale = 1.0 if dtype == "float32" else float(np.abs(want64).max())
        # bf16 rounding leaves the reference itself far from float64
        assert_as_accurate_as_the_reference(
            got, want, want64, ANCHOR_FACTOR, ANCHOR_ATOL[dtype] * scale,
            ref_rtol=1e-4 if dtype == "float32" else None)
        return
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **MODULE_TOL)
    else:
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=BF16_ATOL_OF_MAX * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

# leaves the initializers fill with fixed values (the others are drawn)
FIXED = {"mamba": ["conv_b", "dt_bias", "a_log", "d_skip"],
         "mlstm": ["conv_b", "b_i", "b_f", "skip_w", "norm_w"],
         "slstm": ["b_gates", "norm_w"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_init_has_the_reference_tree_and_fixed_leaves(kind, dtype):
    jp, npp, _ = _params(kind, dtype)
    _, tspec = _specs(kind)
    tp = getattr(tssm, f"init_{kind}")(tcommon.make_generator(0, "cpu"),
                                       tspec, getattr(torch, dtype))
    assert list(tp) == list(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == tuple(jp[k].shape), k
        assert v.dtype == getattr(torch, dtype), k
    # exact, but log(1..16) of the A init within one float32 ulp (each
    # framework's log rounds on its own)
    for k in FIXED[kind]:
        np.testing.assert_allclose(tp[k].float().numpy(), npp[k],
                                   rtol=2.0 ** -23, atol=0, err_msg=k)
    # the drawn leaves: truncated at 2 standard deviations of their scale,
    # which the reference's draws of the same leaves reach
    for k in set(tp) - set(FIXED[kind]):
        w = tp[k].float()
        assert float(w.abs().max()) <= 2.0 * float(np.abs(npp[k]).max()) \
            + 1e-6, k


# ---------------------------------------------------------------------------
# forward, step, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches(kind, length, dtype):
    jspec, tspec = _specs(kind)
    jp, npp, tp = _params(kind, dtype)
    x = _x((2, length, D), dtype)
    want = getattr(jssm, f"{kind}_forward")(jp, jspec,
                                            jnp.asarray(x).astype(dtype))
    got = getattr(tssm, f"{kind}_forward")(tp, tspec, _t(x, dtype))
    assert got.dtype == getattr(torch, dtype)
    want64 = None
    if kind == "mlstm":
        want64 = reference_float64(jssm.mlstm_forward, npp, jspec, x)
    _held(kind, dtype, got, want, want64)


def _step_all(mod, kind, params, spec, xs, state):
    """``init_state`` + ``step`` over the tokens of xs (B, L, d): the
    outputs (B, L, d) and the final state."""
    ys = []
    for t in range(xs.shape[1]):
        y, state = getattr(mod, f"{kind}_step")(params, spec, xs[:, t:t + 1],
                                               state)
        ys.append(y)
    cat = torch.cat if isinstance(ys[0], torch.Tensor) else jnp.concatenate
    return cat(ys, 1), state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_init_state_and_steps_match(kind, dtype):
    """Six tokens, one step each, from the zero state; the states are
    float32 but the conv state, which is in the model dtype."""
    jspec, tspec = _specs(kind)
    jp, npp, tp = _params(kind, dtype)
    x = _x((3, 6, D), dtype, seed=2)
    jstate = getattr(jssm, f"{kind}_init_state")(jspec, 3, jnp.dtype(dtype))
    tstate = getattr(tssm, f"{kind}_init_state")(tspec, 3,
                                                 getattr(torch, dtype), "cpu")
    assert list(tstate) == list(jstate)
    for k, v in tstate.items():
        assert tuple(v.shape) == tuple(jstate[k].shape)
        assert v.dtype == (getattr(torch, dtype) if k == "conv"
                           else torch.float32), k
        assert not bool(v.any())
    assert len({v.data_ptr() for v in tstate.values()}) == len(tstate)
    jy, jst = _step_all(jssm, kind, jp, jspec, jnp.asarray(x).astype(dtype),
                        jstate)
    ty, tst = _step_all(tssm, kind, tp, tspec, _t(x, dtype), tstate)
    want64 = None
    if kind == "mlstm":
        want64 = reference_float64(lambda p, xx: _step_all(
            jssm, kind, p, jspec, xx,
            jssm.mlstm_init_state(jspec, 3, jnp.float64)), npp, x)
    _held(kind, dtype, ty, jy, None if want64 is None else want64[0])
    for k in jst:
        # float32 states carry the model dtype's rounding of their inputs
        _held(kind, dtype, tst[k], jst[k],
              None if want64 is None else want64[1][k])


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_helpers_return_the_reference_states(kind, length):
    jspec, tspec = _specs(kind)
    jp, npp, tp = _params(kind)
    x = _x((2, length, D), "float32", seed=length)
    jfn = getattr(jtransformer, f"_{kind}_prefill")
    jy, jst = jfn(jp, jspec, jnp.asarray(x))
    ty, tst = getattr(ttransformer, f"_{kind}_prefill")(tp, tspec, _t(x))
    w64 = reference_float64(jfn, npp, jspec, x) if kind == "mlstm" \
        else (None, {})
    _held(kind, "float32", ty, jy, w64[0])
    assert list(tst) == list(jst)
    for k in jst:
        _held(kind, "float32", tst[k], jst[k], w64[1].get(k))
    # a prompt shorter than the conv's 3 positions keeps the zero pad
    if "conv" in tst and length < 3:
        assert not bool(tst["conv"][:, :3 - length].any())


@pytest.mark.parametrize("prompt", [2, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_then_steps_equal_the_forward(kind, prompt):
    """Within the port: a prefill of ``prompt`` tokens, then steps, gives
    the forward's outputs on the whole sequence (the JAX package's own
    prefill and steps agree with its forward to 3e-6)."""
    _, tspec = _specs(kind)
    _, _, tp = _params(kind)
    x = _t(_x((2, 9, D), "float32", seed=7))
    whole = getattr(tssm, f"{kind}_forward")(tp, tspec, x)
    y0, state = getattr(ttransformer, f"_{kind}_prefill")(tp, tspec,
                                                          x[:, :prompt])
    ys, _ = _step_all(tssm, kind, tp, tspec, x[:, prompt:], state)
    torch.testing.assert_close(torch.cat([y0, ys], 1), whole, rtol=1e-5,
                               atol=3e-6)


def test_softplus_is_the_reference_softplus_at_large_inputs():
    """``jax.nn.softplus`` is logaddexp(x, 0) at every input; F.softplus
    switches to x itself above 20.  The port's dt takes the reference's."""
    x = np.array([-100.0, -30.0, -20.5, -1.0, 0.0, 1e-3, 1.0, 15.0, 19.9,
                  20.0, 20.1, 25.0, 30.0, 50.0, 88.0, 100.0], np.float32)
    # within a float32 ulp; XLA flushes softplus(-100) = 3.8e-44, a
    # subnormal, to 0
    np.testing.assert_allclose(tssm._softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)
    # Mamba with dt's pre-activation around 25: the softplus above 20
    jspec, tspec = _specs("mamba")
    jp, npp, tp = _params("mamba")
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 25.0))
    tp = dict(tp, dt_bias=torch.full_like(tp["dt_bias"], 25.0))
    x = _x((2, 5, D), "float32", seed=3)
    dt = tssm._mamba_inputs(tp, tspec, _t(x))[2]
    assert float(dt.min()) > 20.0
    _held("mamba", "float32", tssm.mamba_forward(tp, tspec, _t(x)),
          jssm.mamba_forward(jp, jspec, jnp.asarray(x)))


@pytest.mark.parametrize("kind", KINDS)
def test_vmap_over_nodes_equals_a_loop(kind):
    """The trainer's per-node gradients: ``torch.func.vmap`` of the
    forward and of its gradient over a node axis of parameters and inputs
    equals a loop over the nodes."""
    _, tspec = _specs(kind)
    nodes = [_params(kind, seed=s)[2] for s in (1, 2, 3)]
    stacked = {k: torch.stack([p[k] for p in nodes]) for k in nodes[0]}
    xs = _t(_x((3, 2, 7, D), "float32", seed=4))
    fwd = getattr(tssm, f"{kind}_forward")

    def loss(p, x):
        return torch.mean(fwd(p, tspec, x) ** 2)

    got = torch.func.vmap(lambda p, x: fwd(p, tspec, x))(stacked, xs)
    grads = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for i, p in enumerate(nodes):
        torch.testing.assert_close(got[i], fwd(p, tspec, xs[i]), rtol=1e-5,
                                   atol=1e-6)
        want = torch.func.grad(loss)(p, xs[i])
        for k in want:
            torch.testing.assert_close(grads[k][i], want[k], rtol=1e-5,
                                       atol=1e-6, msg=k)
