"""Node axes over two mesh dims and checkpoints of sharded runs, on 4 gloo
ranks on the CPU (test_eight_device_equivalence's toy config, m = 4).

The ranks run in one group, spawned once for the module
(``_torch_mesh_workers.ckpt_cases``; they import the port only) from a
thread, while this process runs the reference and the port on one
device:

  * the reference's ("multi", "faithful") plan, the nodes over ("pod",
    "data") of a (pod=2, data=2, model=1) mesh: a rank's node index is
    row-major over the two dims, pod major (``spmd.node_mesh``, over the
    constructor of a ``DeviceMesh``), and the train steps (dense, banded
    and ppermute phi) and ``train_loop`` (dense, ppermute) equal the same
    nodes over one dim, (data=4, model=1), within 1e-6 and with the same
    wire bytes, and the reference's single-device step at
    test_eight_device_equivalence's bounds;
  * ``train_loop(mesh=, plan=, ckpt_dir=)`` on the faithful (data=2,
    model=2) mesh writes the reference's format from rank 0 alone (every
    rank counts its writes and its prunings), and a crash after step 3
    resumes on the same mesh bit for bit (dense and compressed gossip,
    whose error feedback the checkpoint carries); the same crash resumes
    unsharded and on the two-dim node axis, and an unsharded run's crash
    resumes on the faithful mesh, each within 1e-6 of the run it
    continues; the reference's ``checkpoint.restore`` and
    ``serve.consensus.consensus_params`` read the sharded run's
    checkpoints as the port's readers do.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import _torch_mesh_workers as w
from repro import checkpoint as jckpt
from repro.core import prox as jprox
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.serve import consensus as jconsensus
from repro.train import steps as jsteps
from repro_torch import checkpoint as tckpt
from repro_torch.core import spmd
from repro_torch.serve import consensus as tconsensus

torch.set_num_threads(1)

PARAMS_TOL, LOSS_TOL = 5e-5, 1e-5        # test_eight_device_equivalence
LAYOUT_TOL = 1e-6
SPAWN_TIMEOUT = 300.0
KINDS = ("dense", "banded", "ppermute")
JCFG = JModelConfig(**w.TINY_LM)
INIT = jax.device_get(jtransformer.init_params(JCFG, jax.random.PRNGKey(0)))


def _unsharded_crash(root: str) -> dict:
    """The port's unsharded checkpointed run, and its crash under
    ``root/unsharded-crash`` for the ranks to resume."""
    run = w.lm_train_loop(4, ckpt_dir=os.path.join(root, "unsharded"),
                          **w.CKPT_RUN)
    w.crash_copy(os.path.join(root, "unsharded"),
                 os.path.join(root, "unsharded-crash"))
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the unsharded checkpointed run and the
    reference's single-device steps (computed while the ranks work), and
    the checkpoints' root."""
    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    unsharded = _unsharded_crash(root)
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        spawned = pool.submit(
            spmd.spawn, w.ckpt_cases, w.WORLD,
            args=(INIT, root, os.path.join(root, "unsharded-crash")),
            timeout=SPAWN_TIMEOUT)
        reference = _jax_steps()
        return spawned.result(), unsharded, reference, root


@pytest.fixture(scope="module")
def rank0(runs):
    return runs[0][0]


def _jax_steps() -> dict:
    """The reference's single-device snapshot and two steps (dense phi)."""
    bundle = jsteps.build_train_step(JCFG, jprox.l1(w.LM_LAM), 4,
                                     donate=False)
    state = bundle.init_state(jax.random.PRNGKey(0))
    inputs = w.lm_inputs(JCFG.vocab_size, 4)
    batch = {k: jnp.asarray(v.astype(np.int32))
             for k, v in inputs["batch"].items()}
    state = bundle.snapshot_step(state, batch)
    losses = []
    for phi in inputs["phis"]:
        state, mets = bundle.train_step(state, batch, jnp.asarray(phi),
                                        jnp.float32(w.LM_ALPHA))
        losses.append(float(mets["loss"]))
    return {"params": jax.device_get(state.params),
            "loss": np.asarray(losses)}


def _leaves(tree) -> list:
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in pytree.tree_leaves(tree) if x is not None]


def _max_diff(got, want) -> float:
    return max(float(np.abs(a - b).max())
               for a, b in zip(_leaves(got), _leaves(want), strict=True))


def _by_key(tree) -> dict:
    """{key path: numpy leaf} of a port's or a reference's tree (both
    packages' key strings agree)."""
    if any(isinstance(x, torch.Tensor) for x in pytree.tree_leaves(tree)):
        return {pytree.keystr(p): np.asarray(v.detach()) for p, v in
                pytree.tree_flatten_with_path(tree)[0]}
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _keyed_diff(got, want) -> float:
    g, w_ = _by_key(got), _by_key(want)
    assert g.keys() == w_.keys()
    return max(float(np.abs(g[k] - w_[k]).max()) for k in g)


def _bitwise(got, want) -> None:
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)


def _tail(run, steps) -> dict:
    """The history columns of ``run`` at ``steps``."""
    idx = [list(run["step"]).index(s) for s in steps]
    return {k: run[k][idx] for k in ("loss", "v_norm", "wire_bytes")}


# ---------------------------------------------------------------------------
# node axes over two mesh dims
# ---------------------------------------------------------------------------

def test_a_node_index_is_row_major_over_pod_and_data(runs):
    """Rank r of the (pod=2, data=2, model=1) mesh sits at pod r // 2,
    data r % 2: its node is 2 * pod + data, one row of the m = 4 that
    ``launch.mesh.node_count`` (the dry run's count) gives the plan."""
    for rank, got in enumerate(runs[0]):
        assert got["multi_axis"] == {"index": rank, "ranks": [0, 1, 2, 3],
                                     "rows": [rank, rank + 1],
                                     "name": "pod_data", "node_count": 4}
        assert got["whole_mesh_axis"] == [rank, 4, "pod_data"]


@pytest.mark.parametrize("kind", KINDS)
def test_two_dim_node_axis_equals_one_dim(kind, rank0):
    got, want = rank0[f"steps/multi/{kind}"], rank0[f"steps/data4/{kind}"]
    assert _max_diff(got["params"], want["params"]) < LAYOUT_TOL
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=0,
                               atol=LAYOUT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_two_dim_node_axis_matches_the_references_single_device_step(
        kind, runs):
    got, want = runs[0][0][f"steps/multi/{kind}"], runs[2]
    assert _keyed_diff(got["params"], want["params"]) < PARAMS_TOL
    np.testing.assert_allclose(got["metrics"][:, 0], want["loss"], rtol=0,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("gossip", ["dense", "ppermute"])
def test_two_dim_node_axis_train_loop_equals_one_dim(gossip, rank0):
    got, want = rank0[f"loop/multi/{gossip}"], rank0[f"loop/data4/{gossip}"]
    assert got["wire"] == want["wire"] == "gloo"
    np.testing.assert_array_equal(got["wire_bytes"], want["wire_bytes"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                               atol=LAYOUT_TOL)
    assert _max_diff(got["params"], want["params"]) < LAYOUT_TOL
    unsharded = w.lm_train_loop(4, gossip="dense")
    np.testing.assert_array_equal(got["wire_bytes"],
                                  unsharded["wire_bytes"])
    assert _max_diff(got["params"], unsharded["params"]) < PARAMS_TOL


# ---------------------------------------------------------------------------
# checkpoints of sharded runs
# ---------------------------------------------------------------------------

def test_rank0_alone_writes_and_prunes(runs):
    """Five checkpointed steps in each of the two faithful runs and two in
    each of the four resumes: rank 0 writes all 18 and prunes after each;
    the other ranks write none.  Each directory keeps its newest 3."""
    ranks, _, _, root = runs
    assert ranks[0]["writes"] == {"save": 18, "prune": 18}
    for other in ranks[1:]:
        assert other["writes"] == {"save": 0, "prune": 0}
    for name in ("dense", "compressed", "dense-crash", "to-multi"):
        assert sorted(os.listdir(os.path.join(root, name))) == [
            f"step_{s:08d}" for s in (3, 4, 5)]


@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_sharded_resume_is_bitwise_on_the_same_mesh(kind, rank0):
    full, resumed = rank0[f"ckpt/{kind}"], rank0[f"resumed/{kind}"]
    assert list(resumed["step"]) == [3, 4]
    _bitwise(resumed["state"], full["state"])
    for key, col in _tail(full, [3, 4]).items():
        np.testing.assert_array_equal(resumed[key], col, err_msg=key)


def test_sharded_run_equals_the_unsharded_one(runs):
    rank0, unsharded = runs[0][0], runs[1]
    got = rank0["ckpt/dense"]
    np.testing.assert_array_equal(got["wire_bytes"], unsharded["wire_bytes"])
    np.testing.assert_allclose(got["loss"], unsharded["loss"], rtol=0,
                               atol=LOSS_TOL)
    assert _max_diff(got["params"], unsharded["params"]) < PARAMS_TOL


def test_sharded_checkpoint_resumes_on_other_layouts(runs, tmp_path):
    """The faithful run's crash resumed on the two-dim node axis and on one
    device, and the unsharded run's crash on the faithful mesh."""
    ranks, unsharded, _, root = runs
    rank0 = ranks[0]
    full = rank0["ckpt/dense"]
    w.crash_copy(os.path.join(root, "dense"), str(tmp_path / "crash"))
    on_one = w.lm_train_loop(4, resume=True, ckpt_dir=str(tmp_path / "crash"),
                             **w.CKPT_RUN)
    for got, want in ((rank0["resumed/multi"], full), (on_one, full),
                      (rank0["resumed/from-unsharded"], unsharded)):
        assert list(got["step"]) == [3, 4]
        assert _max_diff(got["state"], want["state"]) < LAYOUT_TOL
        tail = _tail(want, [3, 4])
        np.testing.assert_array_equal(got["wire_bytes"], tail["wire_bytes"])
        np.testing.assert_allclose(got["loss"], tail["loss"], rtol=0,
                                   atol=LAYOUT_TOL)


def test_the_reference_reads_a_sharded_checkpoint(runs):
    """``repro.checkpoint.restore`` gives the gathered final state leaf for
    leaf, and the reference's ``consensus_params`` equals the port's."""
    ranks, _, _, root = runs
    rank0 = ranks[0]
    d = os.path.join(root, "dense")
    template = {"state": jax.eval_shape(
        lambda: jsteps.build_train_step(JCFG, jprox.l1(w.LM_LAM), 4,
                                        donate=False).init_state(
            jax.random.PRNGKey(0)))}
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    tree, step, md = jckpt.restore(d, template)
    assert step == 5 and md["step"] == 5
    state = rank0["ckpt/dense"]["state"]
    for field in ("params", "snapshot", "full_grad"):
        assert _keyed_diff(getattr(state, field),
                           getattr(tree["state"], field)) == 0.0, field
    jparams, jinfo = jconsensus.consensus_params(d, JCFG)
    tparams, tinfo = tconsensus.consensus_params(d, w.lm_cfg("tiny"),
                                                 device="cpu")
    assert _keyed_diff(tparams, jparams) == 0.0
    assert (tinfo.step, tinfo.num_nodes) == (jinfo.step, jinfo.num_nodes)
    # the port's own reader gives the same leaves
    ttree, _, _ = tckpt.restore(d, {"state": state})
    _bitwise(ttree["state"].params, state.params)


def test_a_rank_restores_its_rows_alone(runs):
    """``checkpoint.restore(rows=)`` reads a rank's rows of each stacked
    leaf without the others (the sharded resume's read): the whole
    restore's rows, bit for bit."""
    d = os.path.join(runs[3], "dense")
    template = {"state": runs[1]["state"]}
    whole, step, _ = tckpt.restore(d, template)
    rows, step_rows, _ = tckpt.restore(d, template, rows=slice(1, 3))
    assert step == step_rows == 5
    for field in ("params", "snapshot", "full_grad"):
        for a, b in zip(pytree.tree_leaves(getattr(rows["state"], field)),
                        pytree.tree_leaves(getattr(whole["state"], field))):
            assert torch.equal(a, b[1:3])
