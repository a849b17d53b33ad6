"""The port's SSM models, xlstm-350m (mLSTM and sLSTM blocks, no FFN) and
jamba-1.5-large-398b (attention then 7 Mamba layers, MoE every other
layer), against the JAX package's: the same numpy inputs and the same
parameters (JAX-initialized, carried across by
``convert.params_from_numpy``) through ``forward``, ``prefill`` and
``decode_step`` at the smoke variants' widths, and through the loss's
gradients where the reference scans its layers with remat.  In the smoke
variants at 2 layers jamba is attention + swiglu, then Mamba + a 4-expert
top-2 MoE.  Configs, plans, init trees and the loss are in
``tests/test_torch_models.py``.

Tolerances: jamba's logits at rtol 1e-4 / atol 1e-5, as
tests/test_torch_models.py holds every decoder.

xlstm-350m's logits are ill-conditioned in float32 (its mLSTM normalizer,
tests/test_torch_ssm.py): at 4 layers and 24 tokens the reference's own
float32 logits lie 3.0e-4 from its code run in float64, the port's 3.1e-4,
and a 1e-7 relative change of the embedding moves the reference's logits by
4.5e-4, so no float32 evaluation that sums in another order meets rtol 1e-4
against it.  xlstm is held to the reference run in float64 instead: the
port's logits lie at most twice as far from them as the reference's do,
plus atol 1e-5 (``_torch_parity.assert_as_accurate_as_the_reference``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from _torch_parity import assert_as_accurate_as_the_reference, \
    reference_float64
from repro import configs as jconfigs
from repro.models import api as japi, transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api as tapi, transformer as ttransformer

torch.set_num_threads(1)

MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
SSM_ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(got, want, tol=MODULE_TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, _np(want), **tol)


def _ssm_model(arch, layers):
    jcfg = jconfigs.smoke_variant(jconfigs.get_config(arch)).scaled(
        num_layers=layers)
    tcfg = tconfigs.smoke_variant(tconfigs.get_config(arch)).scaled(
        num_layers=layers)
    jp = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def _f64(jcfg):
    return jcfg.scaled(param_dtype="float64", logit_dtype="float64")


def _logits_held(arch, got, want, want64_fn):
    """xlstm against the reference run in float64 (``want64_fn()``), jamba
    at the logits' tolerance (module docstring)."""
    if arch == "xlstm-350m":
        assert_as_accurate_as_the_reference(got, want, want64_fn())
    else:
        _close(got, want, LOGIT_TOL)


def _np_tree(jtree):
    return jax.tree.map(np.asarray, jtree)


@pytest.mark.parametrize("prompt", [2, 24])
@pytest.mark.parametrize("flags", [dict(),
                                   dict(use_flash=True, use_fused_norm=True)],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("layers", [2, 4])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_prefill_decode_logits_match(arch, layers, flags,
                                                 prompt):
    """A prompt of 2 is shorter than the conv's 3 positions of state; 24 the
    smoke length.  Decode's recurrent states are held as the logits are."""
    jcfg, tcfg, jp, tp = _ssm_model(arch, layers)
    tcfg = tcfg.scaled(**flags)
    np_p = _np_tree(jp)
    toks = np.random.default_rng(prompt).integers(
        0, jcfg.vocab_size, (2, prompt)).astype(np.int32)
    jl, jaux = jtransformer.forward(jcfg, jp, jnp.asarray(toks))
    tl, taux = ttransformer.forward(tcfg, tp, _t(toks))
    _logits_held(arch, tl, jl, lambda: reference_float64(
        lambda p, x: jtransformer.forward(_f64(jcfg), p, x)[0], np_p, toks))
    _close(taux, jaux, MODULE_TOL)
    jl, jc = jtransformer.prefill(jcfg, jp, jnp.asarray(toks), max_len=40)
    tl, tc = ttransformer.prefill(tcfg, tp, _t(toks), max_len=40)
    steps = [np.argmax(_np(jl), -1).astype(np.int32)]
    jls, tls = [jl], [tl]
    for _ in range(3):
        jl, jc = jtransformer.decode_step(jcfg, jp, jc, jnp.asarray(steps[-1]))
        tl, tc = ttransformer.decode_step(tcfg, tp, tc, _t(steps[-1]))
        jls.append(jl)
        tls.append(tl)
        steps.append(np.argmax(_np(jl), -1).astype(np.int32))

    def ref64():
        def run(p, x):
            cfg = _f64(jcfg)
            lg, cache = jtransformer.prefill(cfg, p, x, max_len=40)
            out = [lg]
            for cur in steps[:-1]:
                lg, cache = jtransformer.decode_step(cfg, p, cache,
                                                     jnp.asarray(cur))
                out.append(lg)
            return jnp.stack(out), cache
        return reference_float64(run, np_p, toks)

    w64 = ref64() if arch == "xlstm-350m" else None
    _logits_held(arch, torch.stack(tls), jnp.stack(jls),
                 lambda: w64[0])
    np.testing.assert_array_equal(tc["pos"].numpy(), _np(jc["pos"]))
    for i, (te, je) in enumerate(zip(tc["layers"], jc["layers"])):
        assert list(te) == list(je)
        for (kt, t), (kj, j) in zip(
                sorted(checkpoint_leaves(te)), sorted(checkpoint_leaves(je))):
            assert kt == kj
            if "kv" in kt or arch != "xlstm-350m":
                _close(t, j, LOGIT_TOL)
            else:
                assert_as_accurate_as_the_reference(
                    t, j, dict(checkpoint_leaves(w64[1]["layers"][i]))[kj])


def checkpoint_leaves(entry):
    """(path, leaf) of a cache entry, paths as "mixer/leaf"."""
    return [(f"{k}/{name}", leaf) for k, st in entry.items()
            for name, leaf in st.items()]



@pytest.mark.parametrize("arch,layers", [("jamba-1.5-large-398b", 16),
                                         ("xlstm-350m", 4)])
def test_ssm_loop_equals_the_scanned_remat_layers(arch, layers):
    """Where the reference scans layer groups with remat (jamba's group of
    8 twice, xlstm's group of 2 twice) and cuts Mamba's scan into remat
    chunks of 16 (two over 32 tokens), the port's loops give the same
    logits, aux, loss and gradients.  Logits and gradients are held to the
    reference run in float64: at 16 layers jamba's own float32 logits lie
    1.9e-5 from it (the port's 1.6e-5), past the logits' atol 1e-5 where a
    logit is near 0."""
    jcfg, tcfg, jp, tp = _ssm_model(arch, layers)
    assert japi.scan_group_size(jcfg) == tapi.scan_group_size(tcfg) == \
        layers // 2
    assert tcfg.scan_chunk == 16
    np_p = _np_tree(jp)
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 512, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 32)).astype(np.int32)}
    jl, jaux = jtransformer.forward(jcfg, jp, jnp.asarray(batch["tokens"]))
    tl, taux = ttransformer.forward(tcfg, tp, _t(batch["tokens"]))
    assert_as_accurate_as_the_reference(tl, jl, reference_float64(
        lambda p, x: jtransformer.forward(_f64(jcfg), p, x)[0], np_p,
        batch["tokens"]))
    _close(taux, jaux, MODULE_TOL)
    jloss, jgrad = jax.value_and_grad(jtransformer.loss_fn(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrad = torch.func.grad_and_value(ttransformer.loss_fn(tcfg))(
        tp, {k: _t(v) for k, v in batch.items()})[::-1]
    _close(tloss, jloss, LOGIT_TOL)
    g64 = reference_float64(
        lambda p, b: jax.grad(jtransformer.loss_fn(_f64(jcfg)))(p, b),
        np_p, batch)
    for tg, jg, g in zip(jax.tree.leaves(params_to_numpy(tgrad)),
                         jax.tree.leaves(jgrad), jax.tree.leaves(g64)):
        assert_as_accurate_as_the_reference(tg, jg, g)


def test_xlstm_conditioning_script_runs_on_the_cpu():
    """``benchmarks/pt_xlstm_conditioning.py`` at the smoke size on the CPU:
    every per-position distance, the kernel path (its plain version here)
    equal to the plain path, position 0 determined by float32."""
    from benchmarks import pt_xlstm_conditioning
    out = pt_xlstm_conditioning.main(["--device", "cpu", "--smoke",
                                      "--tokens", "8"])
    per = out["per_position"]
    assert set(per) == {"kernel_vs_plain", "plain_vs_float64",
                        "kernel_vs_float64"}
    assert all(len(v) == 8 for v in per.values())
    assert max(per["kernel_vs_plain"]) == 0.0
    assert per["plain_vs_float64"][0] < 1e-4
    assert out["first_position_over_1e-3"]["kernel_vs_plain"] is None
