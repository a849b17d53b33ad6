"""Shared set-up of the parity tests between the JAX package (``repro``) and
its PyTorch port (``repro_torch``): one numpy problem, fed to both.

Both sides get the same numpy arrays: the JAX side as ``jnp`` arrays, the
port as CPU tensors (``repro_torch.convert``).  The loss is the paper's
Eq. 26 in each framework, written with the same formula.
"""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import algorithm as jalgorithm, graphs as jgraphs, \
    prox as jprox, runner as jrunner
from repro.core.exec_spec import ExecSpec as JExecSpec
from repro.data import synthetic as jsynthetic
from repro_torch.convert import params_from_numpy
from repro_torch.core import algorithm as talgorithm, graphs as tgraphs, \
    prox as tprox, runner as trunner
from repro_torch.core.exec_spec import ExecSpec as TExecSpec

# the parity problems are small: one intra-op thread per test worker keeps
# the xdist workers from oversubscribing the CPU
torch.set_num_threads(1)

M = 8
LAM = 0.01
DPSVRG_HP = dict(alpha=0.2, beta=1.2, n0=4, num_outer=6)
DSPG_HP = dict(alpha0=0.2)
DSPG_STEPS = 150


def jax_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return jnp.mean(-y * logits + jnp.log1p(jnp.exp(logits)))


def torch_loss(w, batch):
    logits = batch["features"] @ w
    y = batch["labels"]
    return torch.mean(-y * logits + torch.log1p(torch.exp(logits)))


@functools.lru_cache(maxsize=None)
def problems(key="adult_like", scale=0.05):
    """(jax Problem, port Problem) on the same partitioned dataset; cached so
    the JAX side's compiled steps are reused across a test file."""
    ds = jsynthetic.make_paper_dataset(key, scale=scale)
    parts = jsynthetic.partition_per_node(ds, M)
    x0 = np.zeros((M, ds.dim), np.float32)
    jp = jalgorithm.Problem(jax_loss, jprox.l1(LAM), jnp.asarray(x0),
                            {k: jnp.asarray(v) for k, v in parts.items()})
    tp = talgorithm.Problem(torch_loss, tprox.l1(LAM),
                            params_from_numpy(x0, "cpu"),
                            params_from_numpy(parts, "cpu"))
    return jp, tp


def build(pkg, name, problem):
    if name == "dpsvrg":
        return pkg.ALGORITHMS[name](
            problem, pkg.DPSVRGHyperParams(**DPSVRG_HP))
    return pkg.ALGORITHMS[name](problem, pkg.DSPGHyperParams(**DSPG_HP),
                                DSPG_STEPS)


def run_jax(name, b, record_every, **spec):
    jp, _ = problems()
    return jrunner.run(build(jalgorithm, name, jp), jp,
                       jgraphs.b_connected_ring_schedule(M, b),
                       JExecSpec(gossip="dense", **spec), seed=0,
                       record_every=record_every)


def run_torch(name, b, record_every, **spec):
    _, tp = problems()
    sched = tgraphs.b_connected_ring_schedule(M, b)
    return trunner.run(build(talgorithm, name, tp), tp, sched,
                       TExecSpec(gossip="dense", device="cpu", **spec),
                       seed=0, record_every=record_every)


# f32 tolerance of whole-run histories: both packages run the same float32
# arithmetic, but sum in different orders (XLA vs ATen matrix products and
# reductions), so values agree to a few float32 ulps per step, compounded
# over ~100 contracting steps
HISTORY_RTOL = 1e-4
HISTORY_ATOL = 1e-6


def assert_histories_match(want, got, *, device_gather=False):
    """Counting columns and ledgers exactly; objective and consensus to f32
    tolerance.  ``device_gather``: ``got`` is a resident run of the port
    that samples minibatches, which it gathers on the device: it skips the
    reference's pull of the dataset to the host, one d2h transfer fewer."""
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field),
                                      err_msg=field)
    for key in ("wire_bytes", "transfers_h2d"):
        np.testing.assert_array_equal(got.extras[key], want.extras[key],
                                      err_msg=key)
    np.testing.assert_array_equal(
        got.extras["transfers_d2h"],
        want.extras["transfers_d2h"] - int(device_gather),
        err_msg="transfers_d2h")
    np.testing.assert_allclose(got.history.objective, want.history.objective,
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                               err_msg="objective")
    np.testing.assert_allclose(got.history.consensus, want.history.consensus,
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                               err_msg="consensus")
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               rtol=HISTORY_RTOL, atol=HISTORY_ATOL,
                               err_msg="params")
