"""The port as a package: it imports neither JAX nor the JAX package, its
entry points run on the CUDA device unless asked for the CPU, it converts
parameters to and from the JAX package's numpy layout, and it refuses, by
name, what it has not ported yet."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import (TExecSpec, build, problems, talgorithm, tgraphs,
                           trunner)
from repro_torch.convert import params_from_numpy, params_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_and_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True).stdout.split(" ", 1)
    assert int(out[0]) >= 40          # every module of the port imported
    assert out[1].strip() == "[]"


def test_run_without_cpu_request_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, tp = problems()
    algo = build(talgorithm, "dspg", tp)
    sched = tgraphs.b_connected_ring_schedule(8, 1)
    for spec in (None, TExecSpec(gossip="dense"),
                 TExecSpec(resident=True, kernel="fused", gossip="dense")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trunner.run(algo, tp, sched, spec, record_every=10)


def test_serving_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer
    cfg = configs.smoke_variant(configs.get_config("h2o-danube-1.8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--requests", "1"])
    params = transformer.init_params(cfg, 0, device="cpu")
    assert params["embed"].device.type == "cpu"
    cache = transformer.init_cache(cfg, 2, 32, device="cpu")
    assert cache["pos"].device.type == "cpu"


def test_run_checks_the_problem_lies_on_the_run_device():
    _, tp = problems()
    sched = tgraphs.b_connected_ring_schedule(8, 1)
    meta_problem = tp._replace(x0=tp.x0.to("meta"))
    with pytest.raises(ValueError, match="lies on meta"):
        trunner.run(build(talgorithm, "dspg", meta_problem), meta_problem,
                    sched, TExecSpec(gossip="dense", device="cpu"),
                    record_every=10)
    np_problem = tp._replace(x0=tp.x0.numpy())
    with pytest.raises(TypeError, match="torch tensors"):
        trunner.run(build(talgorithm, "dspg", np_problem), np_problem,
                    sched, TExecSpec(gossip="dense", device="cpu"),
                    record_every=10)


def test_params_round_trip_through_numpy():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(8, 3, 2)).astype(np.float32),
            "layers": (rng.normal(size=(8, 5)).astype(np.float32),
                       [rng.integers(0, 9, size=(8,)).astype(np.int32)])}
    tensors = params_from_numpy(tree, "cpu")
    assert isinstance(tensors["layers"][1][0], torch.Tensor)
    assert tensors["layers"][1][0].dtype == torch.int32
    back = params_to_numpy(tensors)
    np.testing.assert_array_equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["layers"][0], tree["layers"][0])
    np.testing.assert_array_equal(back["layers"][1][0], tree["layers"][1][0])
    # the tensors own their memory: changing the numpy input changes nothing
    tree["w"][0, 0, 0] = 123.0
    assert float(tensors["w"][0, 0, 0]) != 123.0


@pytest.mark.parametrize("spec_kw,match", [
    (dict(scan=True), "Queue 1 item 5"),
    (dict(resident=True, sampling="device"), "Queue 1 item 5"),
    (dict(gossip="banded"), "Queue 1 item 7"),
    (dict(gossip="auto"), "Queue 1 item 7"),   # picks banded for DSPG
])
def test_unported_paths_raise_by_name(spec_kw, match):
    _, tp = problems()
    kw = dict(dict(gossip="dense", device="cpu"), **spec_kw)
    with pytest.raises(NotImplementedError, match=match):
        trunner.run(build(talgorithm, "dspg", tp), tp,
                    tgraphs.b_connected_ring_schedule(8, 1), TExecSpec(**kw),
                    record_every=10)


def test_unported_algorithm_features_raise_by_name():
    _, tp = problems()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        talgorithm.dpsvrg_algorithm(
            tp, talgorithm.DPSVRGHyperParams(compress_bits=8))
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        trunner.run_sweep(None, {}, None)
    assert sorted(talgorithm.ALGORITHMS) == ["dpsvrg", "dspg"]


def test_quickstart_example_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_quickstart.py"),
         "--device", "cpu", "--resident"],
        capture_output=True, text=True, env=env, check=True).stdout
    assert "DPSVRG   gap" in out and "DSPG     gap" in out
