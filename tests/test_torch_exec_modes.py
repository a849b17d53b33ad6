"""The port's ``scan=True`` path and its device sampling
(``sampling="device"``) against the JAX package, on the CPU.

``scan=True`` draws each record window's minibatch indices from the host
loop's ``np.random`` stream, in its order, and runs the window as the
resident pieces.  Its histories are held to the reference's ``scan=True``
and to the port's own host loop, for every registered algorithm and on the
banded and compressed transports: objective and consensus at rtol 1e-4 /
atol 1e-6 (the reference's batched-vs-sequential consensus tolerance, rtol
1e-3, where a sweep's cells are compared), counting columns and wire bytes
exactly, and the reference's ledger less its pull of the dataset (the port
gathers on the device).

``sampling="device"`` draws from a counter-based stream
(``core.device_sampling``) that differs from the reference's
``jax.random`` one, so it is held as the reference holds its own device
stream (``tests/test_runner_resident.py``): the same convergence envelope
as host sampling, reproducible from the seed; beside that, the indices do
not depend on how a chunk is cut, the host draws after the key (loopless
coin flips) are the reference's draw for draw, batched sweep cells equal
their sequential device-sampled runs, and the LM trainer resumes a
device-sampled run bitwise and refuses a checkpoint of the other
package's device stream.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from _torch_parity import (JExecSpec, M, TExecSpec, jalgorithm, jgraphs,
                           jrunner, problems, talgorithm, tgraphs, trunner)
from repro.core import graphs as jg, prox as jprox, sweep as jsweep
from repro.data.loader import LMLoader as JLoader
from repro.models.api import ModelConfig as JModelConfig
from repro.train import trainer as jtrainer
from repro_torch import checkpoint as tckpt
from repro_torch.core import device_sampling, prox as tprox, sweep as tsweep
from repro_torch.data.loader import LMLoader as TLoader
from repro_torch.models.api import ModelConfig as TModelConfig
from repro_torch.train import trainer as ttrainer
from test_torch_sweep import (ALGORITHMS, OBJ_TOL, CONS_TOL, _builds,
                              _schedules)

torch.set_num_threads(1)

HIST_TOL = dict(rtol=1e-4, atol=1e-6)


def _record_every(name):
    return 0 if name in ("dpsvrg", "inexact_prox_svrg") else 5


def _exact_columns(got, want):
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(got.history, field),
                                      getattr(want.history, field),
                                      err_msg=field)
    np.testing.assert_array_equal(got.extras["wire_bytes"],
                                  want.extras["wire_bytes"])


def _close(got, want, **tol):
    _exact_columns(got, want)
    for col in ("objective", "consensus"):
        np.testing.assert_allclose(getattr(got.history, col),
                                   getattr(want.history, col),
                                   **(tol or HIST_TOL), err_msg=col)


# ---------------------------------------------------------------------------
# scan=True
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALGORITHMS)
def test_scan_matches_the_reference_scan_and_the_host_loop(name):
    jbuild, tbuild = _builds(name)
    jsched, tsched = _schedules(name)
    every = _record_every(name)
    jalgo, jp = jbuild()
    want = jrunner.run(jalgo, jp, jsched,
                       JExecSpec(scan=True, gossip="dense"), seed=0,
                       record_every=every)
    talgo, tp = tbuild()
    got = trunner.run(talgo, tp, tsched,
                      TExecSpec(scan=True, gossip="dense", device="cpu"),
                      seed=0, record_every=every)
    host = trunner.run(talgo, tp, tsched,
                       TExecSpec(gossip="dense", device="cpu"), seed=0,
                       record_every=every)
    _close(got, want)
    _close(got, host)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               **HIST_TOL)
    # one upload a chunk and the records' pulls, as the reference counts
    # them, less the reference's pull of the dataset
    pulled = int(talgo.meta.batch_size > 0)
    assert got.extras["transfers_h2d"] == want.extras["transfers_h2d"]
    assert got.extras["transfers_d2h"] == \
        want.extras["transfers_d2h"] - pulled
    assert got.extras["graphs_built"] == got.extras["replays"] == 0
    assert np.all(np.isfinite(got.history.objective))


@pytest.mark.parametrize("gossip", ["banded", "compressed"])
@pytest.mark.parametrize("name", ["loopless_dpsvrg", "dpsvrg"])
def test_scan_on_banded_and_compressed_transports(name, gossip):
    jp, tp = problems()
    if name == "dpsvrg":
        jalgo = jalgorithm.dpsvrg_algorithm(jp, jalgorithm.DPSVRGHyperParams(
            alpha=0.2, beta=1.2, n0=4, num_outer=5))
        talgo = talgorithm.dpsvrg_algorithm(tp, talgorithm.DPSVRGHyperParams(
            alpha=0.2, beta=1.2, n0=4, num_outer=5))
    else:
        jalgo = jalgorithm.loopless_dpsvrg_algorithm(jp, 0.2, 60,
                                                     snapshot_prob=0.1)
        talgo = talgorithm.loopless_dpsvrg_algorithm(tp, 0.2, 60,
                                                     snapshot_prob=0.1)
    want = jrunner.run(jalgo, jp, jgraphs.b_connected_ring_schedule(M, 1),
                       JExecSpec(scan=True, gossip=gossip), seed=0,
                       record_every=7)
    kw = dict(seed=0, record_every=7)
    sched = tgraphs.b_connected_ring_schedule(M, 1)
    got = trunner.run(talgo, tp, sched,
                      TExecSpec(scan=True, gossip=gossip, device="cpu"), **kw)
    host = trunner.run(talgo, tp, sched,
                       TExecSpec(gossip=gossip, device="cpu"), **kw)
    _close(got, want)
    _close(got, host)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params),
                               **HIST_TOL)


def test_scan_executable_count_and_reset():
    """The pieces a scan run builds: one per distinct piece length (the
    CUDA graphs the card captures), at most log2(MAX_PIECE) + 1 a run,
    summed over runs; reset_executable_caches zeroes the count."""
    _, tbuild = _builds("dpsvrg")
    _, tsched = _schedules("dpsvrg")
    algo, tp = tbuild()
    spec = TExecSpec(scan=True, gossip="dense", device="cpu")
    assert trunner.scan_executable_count(algo) == 0
    trunner.run(algo, tp, tsched, spec, record_every=0)
    first = trunner.scan_executable_count(algo)
    lengths = {1 << b for b in range(
        int(np.log2(trunner.MAX_PIECE)) + 1)}
    # K_s = 3, 3, 4, 5 steps a round: pieces of 1, 2 and 4
    assert 2 <= first <= len(lengths)
    trunner.run(algo, tp, tsched, spec, record_every=0)
    assert trunner.scan_executable_count(algo) == 2 * first
    trunner.reset_executable_caches()
    assert trunner.scan_executable_count(algo) == 0


def test_scan_extra_metrics_ride_the_host_records():
    _, tbuild = _builds("dspg")
    _, tsched = _schedules("dspg")
    algo, tp = tbuild()
    res = trunner.run(algo, tp, tsched,
                      TExecSpec(scan=True, gossip="dense", device="cpu"),
                      record_every=5,
                      extra_metrics={"max": lambda p: float(p.max())})
    assert res.extras["max"].shape == res.history.objective.shape


# ---------------------------------------------------------------------------
# sampling="device": the runner and the sweeps
# ---------------------------------------------------------------------------

def _paper_run(name, sampling, seed=0, **spec):
    _, tp = problems()
    if name == "dpsvrg":
        algo = talgorithm.dpsvrg_algorithm(tp, talgorithm.DPSVRGHyperParams(
            alpha=0.2, beta=1.2, n0=4, num_outer=6))
        every = 0
    elif name == "dspg":
        algo = talgorithm.dspg_algorithm(
            tp, talgorithm.DSPGHyperParams(alpha0=0.2), 150)
        every = 10
    else:
        algo = talgorithm.loopless_dpsvrg_algorithm(tp, 0.2, 150,
                                                    snapshot_prob=0.05)
        every = 10
    return trunner.run(algo, tp, tgraphs.b_connected_ring_schedule(M, 1),
                       TExecSpec(resident=True, sampling=sampling,
                                 gossip="dense", device="cpu", **spec),
                       seed=seed, record_every=every)


@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg"])
def test_device_sampling_lands_in_the_host_sampled_envelope(name):
    """A different stream, the same problem solved: both descend, and the
    final objectives lie within a third of the host run's descent of each
    other (the reference's own check of its device stream)."""
    host = _paper_run(name, "host").history
    dev = _paper_run(name, "device")
    assert not np.allclose(host.objective[1:], dev.history.objective[1:])
    descent = host.objective[0] - host.objective[-1]
    assert descent > 0
    assert dev.history.objective[-1] < dev.history.objective[0]
    assert abs(dev.history.objective[-1] - host.objective[-1]) < descent / 3
    assert (dev.extras["transfers_h2d"], dev.extras["transfers_d2h"]) == \
        (1, 1)
    np.testing.assert_array_equal(dev.history.steps, host.steps)


def test_device_sampling_is_reproducible_from_the_seed():
    a = _paper_run("dspg", "device", seed=3)
    b = _paper_run("dspg", "device", seed=3)
    c = _paper_run("dspg", "device", seed=4)
    np.testing.assert_array_equal(a.history.objective, b.history.objective)
    assert torch.equal(a.params, b.params)
    assert not np.allclose(a.history.objective[1:], c.history.objective[1:])


def test_device_sampled_kernel_modes_agree():
    """The fused step draws the same indices: on the CPU it equals the
    plain step's run to float tolerance."""
    plain = _paper_run("dpsvrg", "device")
    fused = _paper_run("dpsvrg", "device", kernel="fused")
    _close(fused, plain)


@pytest.mark.parametrize("cap", [1, 2, 64])
def test_device_indices_do_not_depend_on_the_piece_cuts(cap, monkeypatch):
    """A piece draws from its steps' numbers: any cut of a chunk gives the
    same indices, so runs cut into other pieces are the same run."""
    stream = device_sampling.IndexStream(77, m=M, bsz=3, n=1000,
                                         device="cpu")
    steps = torch.arange(1, 41)
    whole = stream(steps)
    parts = torch.cat([stream(steps[i:i + cap])
                       for i in range(0, 40, cap)])
    assert torch.equal(whole, parts)
    assert whole.min() >= 0 and whole.max() < 1000
    want = _paper_run("loopless_dpsvrg", "device")
    monkeypatch.setattr(trunner, "MAX_PIECE", cap)
    got = _paper_run("loopless_dpsvrg", "device")
    np.testing.assert_array_equal(got.history.objective,
                                  want.history.objective)
    assert torch.equal(got.params, want.params)


def test_cell_keys_draw_each_cells_own_stream():
    """A stream over several keys is the stack of the one-key streams."""
    steps = torch.arange(5, 12)
    many = device_sampling.IndexStream([3, 9, 27], m=M, bsz=2, n=50,
                                       device="cpu")(steps)
    for c, key in enumerate([3, 9, 27]):
        one = device_sampling.IndexStream(key, m=M, bsz=2, n=50,
                                          device="cpu")(steps)
        assert torch.equal(many[:, c], one)


@pytest.mark.parametrize("name", ["loopless_dpsvrg", "dvr"])
def test_host_draws_after_the_key_are_the_references(name):
    """The key comes first from the run's np.random stream, as the
    reference draws its key seed; the coin flips that follow are the
    reference's draw for draw, so every refresh lands on the same step
    (each charges a full gradient: equal epochs columns)."""
    jbuild, tbuild = _builds(name)
    jsched, tsched = _schedules(name)
    jalgo, jp = jbuild()
    talgo, tp = tbuild()
    want = jrunner.run(jalgo, jp, jsched,
                       JExecSpec(resident=True, sampling="device",
                                 gossip="dense"), seed=5, record_every=3)
    got = trunner.run(talgo, tp, tsched,
                      TExecSpec(resident=True, sampling="device",
                                gossip="dense", device="cpu"),
                      seed=5, record_every=3)
    _exact_columns(got, want)
    host = trunner.run(talgo, tp, tsched,
                       TExecSpec(resident=True, gossip="dense",
                                 device="cpu"), seed=5, record_every=3)
    # host sampling draws indices between the flips: other refresh steps
    assert not np.array_equal(host.history.epochs, got.history.epochs)
    # the step sizes are the plan's, whatever the stream
    assert np.all(np.isfinite(got.history.objective))


@pytest.mark.parametrize("kernel", ["plain", "fused"])
@pytest.mark.parametrize("name", ["dpsvrg", "dspg", "loopless_dpsvrg"])
def test_device_sampled_sweep_cells_equal_sequential_runs(name, kernel):
    """One stream a cell, its key drawn as a sequential run draws it: the
    batched cells equal the sequential device-sampled runs."""
    _, tbuild = _builds(name)
    _, tsched = _schedules(name)
    spec = TExecSpec(resident=True, sampling="device", gossip="dense",
                     device="cpu", kernel=kernel)
    grid = {"lam": [0.003, 0.03], "seed": [0, 1]}
    every = _record_every(name)
    batched = tsweep.run_sweep(tbuild, grid, tsched, spec,
                               record_every=every)
    seq = tsweep.run_sweep(tbuild, grid, tsched, spec, record_every=every,
                           batched=False)
    for field in ("epochs", "comm_rounds", "steps"):
        np.testing.assert_array_equal(getattr(batched.history, field),
                                      getattr(seq.history, field))
    np.testing.assert_allclose(batched.history.objective,
                               seq.history.objective, **OBJ_TOL)
    np.testing.assert_allclose(batched.history.consensus,
                               seq.history.consensus, **CONS_TOL)
    assert (batched.extras["transfers_h2d"],
            batched.extras["transfers_d2h"]) == (1, 1)
    # seeds 0 and 1 draw other streams
    assert not np.allclose(batched.history.objective[1:, 0],
                           batched.history.objective[1:, 1])


def test_device_sampled_sweep_matches_the_reference_envelope():
    """The reference's device-sampled batched sweep and the port's solve
    the same grid: each cell's final objective within a third of its
    descent of the other's."""
    jbuild, tbuild = _builds("dspg")
    jsched, tsched = _schedules("dspg")
    grid = {"lam": [0.003, 0.03]}
    want = jsweep.run_sweep(jbuild, grid, jsched,
                            JExecSpec(resident=True, sampling="device",
                                      gossip="dense"), record_every=5)
    got = tsweep.run_sweep(tbuild, grid, tsched,
                           TExecSpec(resident=True, sampling="device",
                                     gossip="dense", device="cpu"),
                           record_every=5)
    obj_w = np.asarray(want.history.objective)
    obj_g = got.history.objective
    descent = obj_w[0] - obj_w[-1]
    assert np.all(descent > 0)
    assert np.all(np.abs(obj_g[-1] - obj_w[-1]) < descent / 3)


def test_scan_sweeps_run_sequentially():
    """scan=True sweeps take the sequential path (resident=False), each
    cell its own scan run."""
    _, tbuild = _builds("dspg")
    _, tsched = _schedules("dspg")
    grid = {"lam": [0.003, 0.03]}
    res = tsweep.run_sweep(tbuild, grid, tsched,
                           TExecSpec(scan=True, gossip="dense",
                                     device="cpu"), record_every=5)
    host = tsweep.run_sweep(tbuild, grid, tsched,
                            TExecSpec(gossip="dense", device="cpu"),
                            record_every=5)
    np.testing.assert_allclose(res.history.objective, host.history.objective,
                               **HIST_TOL)
    assert res.extras["transfers_h2d"] == 2 * 8      # 8 chunks a cell


# ---------------------------------------------------------------------------
# sampling="device": the LM trainer
# ---------------------------------------------------------------------------

TOY = dict(name="toy-dev", arch_type="dense", num_layers=1, d_model=32,
           num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64)
JCFG, TCFG = JModelConfig(**TOY), TModelConfig(**TOY)
TOKENS = np.random.default_rng(3).integers(0, 64, size=4000).astype(np.int32)
TC = dict(num_steps=12, snapshot_every=5, log_every=3, alpha=0.3,
          consensus_rounds=2, seed=0, ckpt_every=6)


def _ttrain(ckpt_dir=None, resume=False, sampling="device", **kw):
    tc = ttrainer.TrainerConfig(**dict(TC, ckpt_dir=ckpt_dir, **kw))
    ld = TLoader(TOKENS, num_nodes=M // 2, per_node_batch=2, seq_len=16,
                 seed=1)
    return ttrainer.train_loop(
        TCFG, tprox.l1(1e-4), tgraphs.b_connected_ring_schedule(M // 2, 1),
        ld, tc, exec=TExecSpec(resident=True, sampling=sampling,
                               device="cpu"), resume=resume)


def _jtrain(ckpt_dir=None, resume=False, **kw):
    tc = jtrainer.TrainerConfig(**dict(TC, ckpt_dir=ckpt_dir, **kw))
    ld = JLoader(TOKENS, num_nodes=M // 2, per_node_batch=2, seq_len=16,
                 seed=1)
    return jtrainer.train_loop(
        JCFG, jprox.l1(1e-4), jg.b_connected_ring_schedule(M // 2, 1), ld,
        tc, exec=JExecSpec(resident=True, sampling="device"), resume=resume)


def _bitwise(got, want):
    by_step = dict(zip(want["step"], zip(want["loss"], want["v_norm"])))
    assert got["step"]
    for s, l, v in zip(got["step"], got["loss"], got["v_norm"]):
        assert by_step[s] == (l, v)
    for (k, x), (_, y) in zip(tckpt.flatten_with_paths(got["final_state"]),
                              tckpt.flatten_with_paths(want["final_state"])):
        assert torch.equal(x, y), k


@pytest.fixture(scope="module")
def device_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dev_full"))
    return _ttrain(ckpt_dir=d), d


@pytest.mark.parametrize("alg", ["dpsvrg", "dspg"])
def test_device_sampled_training_falls_and_repeats(alg):
    a = _ttrain(algorithm=alg)
    b = _ttrain(algorithm=alg)
    host = _ttrain(algorithm=alg, sampling="host")
    _bitwise(a, b)
    assert np.all(np.isfinite(a["loss"]))
    assert a["loss"][-1] < a["loss"][0]
    assert a["loss"] != host["loss"]
    # one staging transfer, one pull a record window: the ledger of host
    # sampling
    assert a["transfers"] == host["transfers"] == {"h2d": 1, "d2h": 5}
    assert a["alpha"] == host["alpha"]
    assert a["wire_bytes"] == host["wire_bytes"]


def test_device_sampled_resume_is_bitwise(device_run, tmp_path):
    full, d = device_run
    crash = str(tmp_path / "crash")
    shutil.copytree(d, crash)
    shutil.rmtree(os.path.join(crash, "step_00000012"))
    assert tckpt.latest_step(crash) == 6
    res = _ttrain(ckpt_dir=crash, resume=True)
    assert res["step"] == [6, 9, 11]
    _bitwise(res, full)
    assert int(res["final_state"].step) == 12
    tree, _, md = tckpt.restore(crash, {"key": torch.zeros(1)})
    assert md["device_stream"] == ttrainer.DEVICE_STREAM
    assert int(tree["key"][0]) == device_sampling.trainer_key(0)


def test_device_checkpoints_do_not_cross_packages(device_run, tmp_path):
    """The streams differ, so neither package continues the other's
    device-sampled run: the port refuses the reference's checkpoint by
    name, the reference refuses the port's by the key's shape."""
    jdir = str(tmp_path / "jax")
    _jtrain(ckpt_dir=jdir)
    with pytest.raises(ValueError, match="device streams differ"):
        _ttrain(ckpt_dir=jdir, resume=True)
    _, d = device_run
    tdir = str(tmp_path / "torch")
    shutil.copytree(d, tdir)
    with pytest.raises(ValueError, match="shape mismatch for key"):
        _jtrain(ckpt_dir=tdir, resume=True)
    # a host-sampled checkpoint holds no stream: refused as well
    hdir = str(tmp_path / "host")
    _ttrain(ckpt_dir=hdir, sampling="host")
    with pytest.raises(ValueError, match="device streams differ"):
        _ttrain(ckpt_dir=hdir, resume=True)


def test_launch_train_runs_with_device_sampling(capsys):
    from repro_torch.launch import train as launch_train
    hist = launch_train.main(["--arch", "minicpm-2b", "--steps", "3",
                              "--device", "cpu", "--sampling", "device"])
    assert hist["step"] == [0, 1, 2]
    assert np.all(np.isfinite(hist["loss"]))
    assert hist["transfers"] == {"h2d": 1, "d2h": 3}
    with pytest.raises(ValueError, match="resident=True"):
        launch_train.main(["--steps", "2", "--device", "cpu", "--host",
                           "--sampling", "device"])
