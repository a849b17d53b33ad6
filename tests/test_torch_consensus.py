"""The training -> serving bridge of the port against the JAX package's
(``repro.serve.consensus``, ``repro.train.evaluate``): the consensus
parameters and ``ConsensusInfo`` of the same checkpoint directory, written
by either package, agree (float32 leaves within rtol 1e-6: both means are
formed in float64 and cast; distances within rtol 1e-6), the held-out
evaluation of the same parameters agrees, and the port's launchers train,
checkpoint and serve the consensus end to end on the CPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import graphs as jgraphs, prox as jprox
from repro.data.loader import LMLoader as JLoader
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.serve import consensus as jconsensus
from repro.train import evaluate as jevaluate, trainer as jtrainer
from repro_torch import checkpoint as tckpt
from repro_torch.convert import params_from_numpy
from repro_torch.core import graphs as tgraphs, prox as tprox
from repro_torch.core.exec_spec import ExecSpec
from repro_torch.data.loader import LMLoader as TLoader
from repro_torch.models.api import ModelConfig as TModelConfig
from repro_torch.serve import consensus as tconsensus
from repro_torch.train import evaluate as tevaluate, trainer as ttrainer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(name="tiny-consensus", arch_type="dense", num_layers=1,
            d_model=16, num_heads=1, num_kv_heads=1, d_ff=32, vocab_size=64)
JCFG, TCFG = JModelConfig(**TINY), TModelConfig(**TINY)
M = 4
TOKENS = np.random.default_rng(0).integers(0, 64, size=4_000).astype(
    np.int32)
# ONE consensus round: on the 4-ring two rounds mix to exact uniform
# averaging, which would leave no per-node disagreement to observe
TC = dict(num_steps=6, snapshot_every=6, log_every=6, alpha=0.05,
          consensus_rounds=1, seed=0, ckpt_every=6)


def _train(pkg, ckpt_dir):
    if pkg == "jax":
        ld = JLoader(TOKENS, num_nodes=M, per_node_batch=1, seq_len=8, seed=1)
        jtrainer.train_loop(JCFG, jprox.l1(1e-5),
                            jgraphs.b_connected_ring_schedule(M, b=2, seed=0),
                            ld, jtrainer.TrainerConfig(ckpt_dir=ckpt_dir,
                                                       **TC))
    else:
        ld = TLoader(TOKENS, num_nodes=M, per_node_batch=1, seq_len=8, seed=1)
        ttrainer.train_loop(TCFG, tprox.l1(1e-5),
                            tgraphs.b_connected_ring_schedule(M, b=2, seed=0),
                            ld, ttrainer.TrainerConfig(ckpt_dir=ckpt_dir,
                                                       **TC),
                            exec=ExecSpec(device="cpu"))
    return ckpt_dir


@pytest.fixture(scope="module", params=["jax", "torch"])
def ckpt_dir(request, tmp_path_factory):
    """A train_loop checkpoint written by each package."""
    return _train(request.param,
                  str(tmp_path_factory.mktemp(f"ckpt_{request.param}")))


def _by_key(params):
    if isinstance(jax.tree.leaves(params)[0], torch.Tensor):
        return {k: v.numpy() for k, v in tckpt.flatten_with_paths(params)}
    return {"/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def test_consensus_equals_the_reference(ckpt_dir):
    want, winfo = jconsensus.consensus_params(ckpt_dir, JCFG)
    got, info = tconsensus.consensus_params(ckpt_dir, TCFG, device="cpu")
    assert (info.step, info.num_nodes, info.algorithm) == \
        (winfo.step, winfo.num_nodes, winfo.algorithm) == (6, M, "dpsvrg")
    np.testing.assert_allclose(info.node_dist, winfo.node_dist, rtol=1e-6)
    np.testing.assert_allclose(info.consensus_rel, winfo.consensus_rel,
                               rtol=1e-6)
    assert max(info.node_dist) > 0
    assert str(info).startswith("consensus ckpt step=6 m=4 algorithm=dpsvrg")
    gk, wk = _by_key(got), _by_key(want)
    assert sorted(gk) == sorted(wk)
    for k in wk:
        assert gk[k].dtype == wk[k].dtype == np.float32
        np.testing.assert_allclose(gk[k], wk[k], rtol=1e-6, atol=0,
                                   err_msg=k)


def test_consensus_is_the_node_mean_on_the_requested_device(ckpt_dir):
    got, _ = tconsensus.consensus_params(ckpt_dir, TCFG, device="cpu")
    arrays = np.load(os.path.join(ckpt_dir, "step_00000006", "arrays.npz"))
    for k, v in _by_key(got).items():
        stacked = arrays["state/.params/" + k]
        np.testing.assert_allclose(
            v, stacked.astype(np.float64).mean(axis=0), rtol=1e-6)
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(got))


def test_consensus_refuses_a_missing_or_foreign_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        tconsensus.consensus_params(str(tmp_path), TCFG, device="cpu")
    tckpt.save(str(tmp_path), 1, {"state": {"w": np.zeros(3)}})
    with pytest.raises(ValueError, match="not a train_loop checkpoint"):
        tconsensus.consensus_params(str(tmp_path), TCFG, device="cpu")


def test_consensus_refuses_a_config_of_other_shapes(ckpt_dir):
    wide = TModelConfig(**dict(TINY, d_ff=48))
    with pytest.raises(ValueError, match="shape mismatch"):
        tconsensus.consensus_params(ckpt_dir, wide, device="cpu")


# ---------------------------------------------------------------------------
# held-out evaluation
# ---------------------------------------------------------------------------

def _stacked_params(seed=0):
    params = jax.device_get(jtransformer.init_params(
        JCFG, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return params, jax.tree.map(
        lambda a: (a[None] + 0.05 * rng.normal(size=(M,) + a.shape))
        .astype(np.float32), params)


def test_evaluate_lm_equals_the_reference():
    params, _ = _stacked_params()
    kw = dict(batch=4, seq_len=16, max_batches=3, seed=2)
    want = jevaluate.evaluate_lm(JCFG, params, TOKENS, **kw)
    got = tevaluate.evaluate_lm(TCFG, params_from_numpy(params, "cpu"),
                                TOKENS, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_evaluate_stacked_equals_the_reference():
    _, stacked = _stacked_params(1)
    kw = dict(batch=2, seq_len=8, max_batches=2, seed=0)
    want = jevaluate.evaluate_stacked(JCFG, stacked, TOKENS, **kw)
    got = tevaluate.evaluate_stacked(TCFG, params_from_numpy(stacked, "cpu"),
                                     TOKENS, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        # node_nll_std is a small difference of nearby losses
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the launchers: train -> checkpoint -> serve, on the CPU
# ---------------------------------------------------------------------------

def test_launch_train_then_serve_the_consensus(tmp_path, capsys):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    d = str(tmp_path / "run")
    hist = launch_train.main(["--arch", "minicpm-2b", "--steps", "2",
                              "--ckpt-dir", d, "--device", "cpu",
                              "--tracker", f"jsonl:{tmp_path}/m.jsonl"])
    assert hist["transfers"] == {"h2d": 1, "d2h": 3}
    assert tckpt.latest_step(d) == 2
    assert len((tmp_path / "m.jsonl").read_text().splitlines()) == 3
    summary = launch_serve.main([
        "--arch", "minicpm-2b", "--ckpt-dir", d, "--slots", "2",
        "--max-len", "48", "--requests", "3", "--prompt-len", "8",
        "--new", "4", "--device", "cpu"])
    assert summary["requests"] == 3 and summary["tokens"] == 3 * 4
    out = capsys.readouterr().out
    assert "consensus ckpt step=2 m=4" in out and "tok/s" in out
    # --resume continues from the newest checkpoint
    hist = launch_train.main(["--arch", "minicpm-2b", "--steps", "4",
                              "--ckpt-dir", d, "--ckpt-every", "2",
                              "--device", "cpu", "--host", "--resume"])
    assert hist["step"][0] == 2 and tckpt.latest_step(d) == 4
    # --sampling device draws the windows on the device, and runs
    hist = launch_train.main(["--steps", "2", "--device", "cpu",
                              "--sampling", "device"])
    assert hist["transfers"] == {"h2d": 1, "d2h": 2}
    assert np.all(np.isfinite(hist["loss"]))


def test_launch_train_module_runs_as_a_script(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--steps", "2", "--host"],
        capture_output=True, text=True, env=env, check=True).stdout
    assert "step loss:" in out and "'h2d': 2" in out


def test_reference_serves_the_consensus_of_a_port_checkpoint(tmp_path):
    """The port's trainer checkpoint feeds the reference's serving."""
    d = _train("torch", str(tmp_path / "t"))
    params, info = jconsensus.consensus_params(d, JCFG)
    assert info.num_nodes == M
    logits, _ = jtransformer.prefill(JCFG, params,
                                     np.arange(5, dtype=np.int32)[None])
    assert np.all(np.isfinite(np.asarray(logits)))
