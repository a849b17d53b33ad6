"""The model zoo across ranks, on 4 gloo ranks on the CPU: the smoke
variant of every arch of ``configs`` (all but the logistic regression)
served through sharded ``build_serve_steps(plan=, mesh=)``, and every arch
that trains on tokens alone (all but whisper-base and llava, whose batches
carry stub modality inputs) trained through a sharded
``build_train_step``, on the faithful (data=2, model=2) mesh with m = 2
(a node a data rank, each leaf a DTensor over model).

The ranks run in one group, spawned once for the module
(``_torch_mesh_workers.zoo_cases``; they import the port only) from a
thread, so that this process computes the reference's runs (jitted) while
they work, and holds them:

  * serving (2 requests, a prefill of 8 tokens after the stub audio or
    image rows, and 2 greedy decode steps): the reference's tokens, and
    its logits within 1e-4; the port's unsharded tokens and logits;
  * training (a snapshot refresh and two DPSVRG steps): the reference's
    single-device ``build_train_step`` at test_eight_device_equivalence's
    bounds (params within 5e-5, loss within 1e-5) and the port's
    unsharded step (params within 1e-6, loss within 1e-5);
  * Mamba and mLSTM, which run on each rank's channels
    (``placed.channel_call``), alone on model=2 and model=4: the halves of
    the up-projection's product regrouped to each rank's channels exactly,
    and forward, gradients, prefill state and a decode step equal to the
    whole mixer.

xlstm's float32 results are ill-conditioned at random init (the mLSTM
normalizer's poles; ``benchmarks/pt_xlstm_conditioning.py``): where the
split sums (the inner norm over every head, the gathered gates) round
otherwise than one device's, its training and the mLSTM mixer are held to
the reference's own code run in float64 (``_torch_parity.
reference_float64``): the sharded run lies at most twice as far from it
as the float32 run it is compared with, plus 1e-5.
"""

import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_mesh_workers as w
from _torch_parity import assert_as_accurate_as_the_reference, \
    reference_float64, reference_in_float64
from repro import configs as jconfigs
from repro.core import prox as jprox
from repro.models import ssm as jssm, transformer as jtransformer
from repro.models.api import layer_plan as jlayer_plan
from repro.train import steps as jsteps
from repro_torch.core import spmd

torch.set_num_threads(1)

PARAMS_TOL, LOSS_TOL = 5e-5, 1e-5        # test_eight_device_equivalence
UNSHARDED_TOL = 1e-6
LOGITS_TOL = 1e-4
MIXER_TOL = 1e-6
# a gradient summed over the batch and the positions in another order (the
# products split over channels): within 1e-5 of the leaf's largest entry
GRAD_RTOL = 1e-5
SPAWN_TIMEOUT = 400.0
ARCHS = list(w.zoo_archs())
TRAINED = [a for a in ARCHS if w.zoo_trained(a)]
ILL_CONDITIONED = "xlstm-350m"
MIXER_CASES = [f"{kind}/{mesh}" for kind in w.ZOO_MIXERS
               for mesh in ("model2", "model4")]


def _jcfg(arch: str):
    cfg = jconfigs.smoke_variant(jconfigs.get_config(arch))
    return cfg.scaled(use_flash=False, use_fused_norm=False)


INITS = {arch: jax.device_get(jtransformer.init_params(
    _jcfg(arch), jax.random.PRNGKey(0))) for arch in ARCHS}
MIXERS = {kind: w.mixer_inputs(kind, w.lm_cfg(arch).d_model)
          for kind, (arch, _) in w.ZOO_MIXERS.items()}


@pytest.fixture(scope="module")
def runs():
    """The ranks' results and the reference's runs, which this process
    computes while the ranks work."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as spawner, \
            concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        spawned = spawner.submit(spmd.spawn, w.zoo_cases, w.WORLD,
                                 args=(INITS, MIXERS), timeout=SPAWN_TIMEOUT)
        # jax.jit compiles in threads in parallel (XLA releases the GIL)
        jobs = {f"serve/{arch}": pool.submit(_jax_serve, arch)
                for arch in ARCHS}
        jobs.update({f"train/{arch}": pool.submit(_jax_steps, arch)
                     for arch in TRAINED})
        refs = {k: job.result() for k, job in jobs.items()}
        # the float64 runs patch the reference's modules: alone
        with reference_in_float64():
            refs["train64"] = _jax_steps(ILL_CONDITIONED, in_float64=True)
        refs["mlstm64"] = _float64_mixer("mlstm")
        return spawned.result(), refs


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def rank0(runs):
    return runs[0][0]


@pytest.fixture(scope="module")
def refs(runs):
    return runs[1]


def _leaves(tree) -> list:
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in pytree.tree_leaves(tree)]


def _max_diff(got, want) -> float:
    return max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(got), _leaves(want)))


def _stacked(tree, m: int, dtype=None):
    return jax.tree.map(lambda x: jnp.asarray(
        np.broadcast_to(x, (m,) + x.shape), dtype=dtype), tree)


def _jax_steps(arch: str, in_float64: bool = False) -> dict:
    """The reference's single-device snapshot refresh and two steps from
    ``INITS[arch]`` (float64 throughout with ``in_float64``)."""
    cfg = _jcfg(arch)
    dtype = None
    if in_float64:
        cfg = cfg.scaled(param_dtype="float64", logit_dtype="float64")
        dtype = jnp.float64
    bundle = jsteps.build_train_step(cfg, jprox.l1(w.LM_LAM), w.ZOO_M,
                                     donate=False)
    params = _stacked(INITS[arch], w.ZOO_M, dtype)
    state = jsteps.TrainState(params=params, snapshot=params,
                              full_grad=jax.tree.map(jnp.zeros_like, params),
                              step=jnp.zeros((), jnp.int32))
    inputs = w.lm_inputs(cfg.vocab_size, w.ZOO_M)
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in inputs["batch"].items()}
    state = bundle.snapshot_step(state, batch)
    losses = []
    for phi in inputs["phis"]:
        state, mets = bundle.train_step(state, batch,
                                        jnp.asarray(phi, dtype),
                                        w.LM_ALPHA)
        losses.append(float(mets["loss"]))
    return {"params": jax.device_get(state.params),
            "loss": np.asarray(losses)}


def _jax_serve(arch: str, decode: int = 2) -> dict:
    """The reference's jitted prefill and greedy decode steps."""
    cfg = _jcfg(arch)
    prompts = jnp.asarray(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 8)).astype(np.int32))
    modality = {k: jnp.asarray(v)
                for k, v in w.lm_modality(w.lm_cfg(arch)).items()}
    prefix = modality["image_embeds"].shape[1] \
        if "image_embeds" in modality else 0
    prefill = jax.jit(functools.partial(
        jtransformer.prefill, cfg, max_len=prefix + 8 + decode))
    decode_step = jax.jit(functools.partial(jtransformer.decode_step, cfg))
    logits, cache = prefill(INITS[arch], prompts, **modality)
    outs, toks = [np.asarray(logits)], []
    for _ in range(decode):
        tok = jnp.argmax(jnp.asarray(outs[-1]), axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = decode_step(INITS[arch], cache, tok)
        outs.append(np.asarray(logits))
    return {"tokens": np.stack(toks, axis=1), "logits": np.stack(outs)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_gives_the_references_tokens(arch, rank0, refs):
    got, want = rank0[f"serve/{arch}"], refs[f"serve/{arch}"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGITS_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _held(got, want, want64, tol):
    """``got``'s leaves within ``tol`` of ``want``'s, or, for the
    ill-conditioned arch (``want64`` given), at most twice as far from the
    float64 run as ``want``'s are, plus 1e-5."""
    if want64 is None:
        assert _max_diff(got, want) < tol
        return
    for g, f, f64 in zip(_leaves(got), _leaves(want), _leaves(want64)):
        # no check that the float32 run lies near the float64 one: the l1
        # prox puts leaves that start at 0 (the norms, the gate biases)
        # at a few 1e-5, where float32 parts from float64 by its rounding
        assert_as_accurate_as_the_reference(g, f, f64, ref_rtol=None)


@pytest.mark.parametrize("arch", TRAINED)
def test_sharded_step_matches_the_references_single_device_step(arch,
                                                                 rank0,
                                                                 refs):
    got, want = rank0[f"train/{arch}"], refs[f"train/{arch}"]
    want64 = refs["train64"] if arch == ILL_CONDITIONED else None
    _held(got["params"], want["params"], want64 and want64["params"],
          PARAMS_TOL)
    _held(got["metrics"][:, 0], want["loss"], want64 and want64["loss"],
          LOSS_TOL)


@pytest.mark.parametrize("arch", TRAINED)
def test_sharded_step_matches_the_ports_unsharded_step(arch, rank0, refs):
    want = w.lm_train_steps(w.lm_cfg(arch), INITS[arch], w.ZOO_M, "dense")
    got = rank0[f"train/{arch}"]
    want64 = refs["train64"] if arch == ILL_CONDITIONED else None
    _held(got["params"], want["params"], want64 and want64["params"],
          UNSHARDED_TOL)
    _held(got["metrics"][:, 0], want["metrics"][:, 0],
          want64 and want64["loss"], LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_the_ports_unsharded_serving(arch, rank0):
    want = w.lm_serve(w.lm_cfg(arch, serve=True), INITS[arch])
    got = rank0[f"serve/{arch}"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"].numpy())
    np.testing.assert_allclose(got["logits"], want["logits"].numpy(),
                               rtol=0, atol=LOGITS_TOL)


def test_every_rank_returns_the_same_result(ranks):
    for other in ranks[1:]:
        assert other["regions"] == ranks[0]["regions"]
        for name in set(ranks[0]) - {"regions"}:
            assert _max_diff(other[name], ranks[0][name]) == 0.0, name


def test_the_ssm_mixers_ran_on_each_ranks_channels(rank0):
    """jamba's Mamba layer and xlstm's mLSTM block ran through the
    channel regions in their sharded serving, and only sLSTM through the
    replicated call."""
    assert rank0["regions"] == {
        "jamba-1.5-large-398b": {"channel_call": ["mamba"] * 3,
                                 "replicated_call": []},
        "xlstm-350m": {"channel_call": ["mlstm"] * 3,
                       "replicated_call": ["slstm"] * 3}}


# ---------------------------------------------------------------------------
# Mamba and mLSTM on each rank's channels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", MIXER_CASES)
def test_channel_regions_regroup_the_up_projections_halves(case, rank0):
    """The up-projection's spec splits its 2 x d_inner columns in place
    (on model=2 one rank holds all of the first half); the region hands
    each rank its channels of both halves, which gathered give the whole
    halves bit for bit."""
    kind = case.split("/")[0]
    want = w.mixer_run(kind, MIXERS[kind])["halves"]
    for got, half in zip(rank0[f"mixer/{case}"]["halves"], want):
        np.testing.assert_array_equal(got, half.numpy())


def _jmixer_spec(kind):
    arch = w.ZOO_MIXERS[kind][0]
    return next(getattr(p, kind) for p in jlayer_plan(_jcfg(arch))
                if p.mixer == kind)


def _float64_mixer(kind):
    """The reference's mLSTM forward and its gradient by the weights and
    the input in float64 (the cotangent's inner product)."""
    inputs = MIXERS[kind]
    spec = _jmixer_spec(kind)

    def fwd_and_grads(p, x, cot):
        fwd = lambda p_, x_: jssm.mlstm_forward(p_, spec, x_)  # noqa
        out = fwd(p, x)
        grads = jax.grad(lambda p_, x_: jnp.sum(fwd(p_, x_) * cot),
                         argnums=(0, 1))(p, x)
        return out, dict(grads[0], x=grads[1])

    return reference_float64(fwd_and_grads, inputs["params"], inputs["x"],
                             inputs["cot"])


@pytest.mark.parametrize("case", MIXER_CASES)
def test_channel_regions_match_the_whole_mixer(case, rank0, refs):
    """Forward, the gradient of <forward, cot> by each weight and the
    input, the prefill's state and a decode step from it, on each rank's
    channels, against the mixer on one device: within 1e-6 (Mamba);
    mLSTM's forward and gradients, ill-conditioned, against its float64
    run."""
    kind = case.split("/")[0]
    got, want = rank0[f"mixer/{case}"], w.mixer_run(kind, MIXERS[kind])
    if kind == "mlstm":
        out64, grads64 = refs["mlstm64"]
        assert_as_accurate_as_the_reference(got["out"], want["out"], out64)
        for name in want["grads"]:
            assert_as_accurate_as_the_reference(
                got["grads"][name], want["grads"][name], grads64[name])
    else:
        assert _max_diff(got["out"], want["out"]) < MIXER_TOL
        for name in want["grads"]:
            g = want["grads"][name].numpy()
            np.testing.assert_allclose(
                got["grads"][name], g, rtol=0,
                atol=GRAD_RTOL * float(np.abs(g).max()), err_msg=name)
    for key in ("state", "step", "new_state"):
        np.testing.assert_allclose(
            np.concatenate([x.ravel() for x in _leaves(got[key])]),
            np.concatenate([x.ravel() for x in _leaves(want[key])]),
            rtol=1e-5, atol=MIXER_TOL, err_msg=key)
