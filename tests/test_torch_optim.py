"""The port's functional optimizers against the JAX package's
(``repro.optim``) on the same numpy trees.  Float32 throughout, so the two
agree to float32 rounding: rtol 1e-6 for one update, 1e-5 after five
AdamW steps (the bias corrections and square roots of each step round
in each framework's own order)."""

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.convert import params_from_numpy, params_to_numpy


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)}]}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape)
                          .astype(np.float32), params) for _ in range(5)]
    return params, grads


def _close(got, want, rtol):
    for g, w in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(jax.device_get(want))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_global_norm_and_clip_equal_the_reference(max_norm):
    _, grads = _trees()
    g = grads[0]
    np.testing.assert_allclose(
        float(toptim.global_norm(params_from_numpy(g, "cpu"))),
        float(joptim.global_norm(g)), rtol=1e-6)
    got, gn = toptim.clip_by_global_norm(params_from_numpy(g, "cpu"),
                                         max_norm)
    want, jn = joptim.clip_by_global_norm(g, max_norm)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}),
                                     ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.1})])
def test_updates_equal_the_reference_over_five_steps(name, kw):
    params, grads = _trees(1)
    jopt, topt = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    jp, tp = params, params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        if name == "adamw":
            ju, js = jopt.update(g, js, 0.01, jp)
            tu, ts = topt.update(params_from_numpy(g, "cpu"), ts, 0.01, tp)
        else:
            ju, js = jopt.update(g, js, 0.01)
            tu, ts = topt.update(params_from_numpy(g, "cpu"), ts, 0.01)
        _close(tu, ju, 1e-5)
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
    _close(tp, jp, 1e-5)
    if name == "adamw":
        assert int(ts.count) == int(js.count) == len(grads)
        assert ts.count.dtype == torch.int32
