"""The port's checkpoints against the JAX package's (``repro.checkpoint``):
the same layout, leaf keys and metadata bytes, so a checkpoint saved by
either package restores in the other.  ``meta.msgpack`` is written by the
port's own codec, held here against the ``msgpack`` package in both
directions."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import compression as jcompression
from repro.data.loader import LMLoader as JLoader
from repro.models import transformer as jtransformer
from repro.models.api import ModelConfig as JModelConfig
from repro.train import steps as jsteps
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import _msgpack
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as tcompression
from repro_torch.train import steps as tsteps

TOY = dict(name="toy-ckpt", arch_type="dense", num_layers=2, d_model=16,
           num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64)
M = 3


# ---------------------------------------------------------------------------
# the msgpack codec
# ---------------------------------------------------------------------------

CODEC_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, float("inf"), "", "a" * 31,
    "a" * 32, "é" * 200, "x" * 70000, b"", b"ab" * 200, b"z" * 70000, [],
    list(range(15)), list(range(16)), list(range(70000)), {},
    {str(i): i for i in range(15)}, {str(i): [i, None] for i in range(16)},
    (1, "a", [None, {"k": -5}]),
]


@pytest.mark.parametrize("case", range(len(CODEC_CASES)))
def test_codec_bytes_equal_the_msgpack_package(case):
    obj = CODEC_CASES[case]
    ours = _msgpack.packb(obj)
    assert ours == msgpack.packb(obj)
    assert _msgpack.unpackb(msgpack.packb(obj)) == msgpack.unpackb(ours)


def test_codec_reads_float32_and_refuses_what_it_does_not_hold():
    assert _msgpack.unpackb(msgpack.packb(1.25, use_single_float=True)) \
        == 1.25
    with pytest.raises(TypeError, match="cannot serialize"):
        _msgpack.packb({"x": np.int64(1)})
    with pytest.raises(OverflowError):
        _msgpack.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb("abc")[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_codec_round_trips_a_trainer_metadata():
    ld = JLoader(np.arange(4000, dtype=np.int32), 4, 2, 16, seed=3)
    ld.sample()
    meta = {"step": 10, "metadata": {"step": 10, "slot": 20,
                                     "wire": 2 ** 40 + 3,
                                     "algorithm": "dpsvrg",
                                     "loader": ld.state_dict()},
            "paths": ["key", "state/.step"], "dtypes": {}}
    ours = _msgpack.packb(meta)
    assert ours == msgpack.packb(meta)
    assert _msgpack.unpackb(ours) == msgpack.unpackb(ours) == meta


# ---------------------------------------------------------------------------
# leaf keys and cross-package restores
# ---------------------------------------------------------------------------

def _states(mix_state: bool, cfg=TOY):
    """The same TrainState in both packages, from numpy leaves."""
    jcfg = JModelConfig(**cfg)
    params = jax.device_get(jtransformer.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    stacked = jax.tree.map(
        lambda a: (a[None] + rng.normal(size=(M,) + a.shape)
                   .astype(np.float32)), params)
    grads = jax.tree.map(lambda a: 0.5 * a, stacked)
    jmix = jcompression.init_state(stacked) if mix_state else None
    jstate = jsteps.TrainState(params=stacked, snapshot=stacked,
                               full_grad=grads,
                               step=np.asarray(7, np.int32),
                               mix_state=jax.device_get(jmix))
    tparams = params_from_numpy(stacked, "cpu")
    tmix = tcompression.init_state(tparams) if mix_state else None
    tstate = tsteps.TrainState(params=tparams, snapshot=tparams,
                               full_grad=params_from_numpy(grads, "cpu"),
                               step=torch.tensor(7, dtype=torch.int32),
                               mix_state=tmix)
    return jstate, tstate


def _jax_keys(tree):
    return sorted("/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                           for e in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("mix_state", [False, True])
def test_train_state_keys_equal_the_reference(tmp_path, mix_state):
    jstate, tstate = _states(mix_state)
    want = _jax_keys({"state": jstate})
    got = sorted(k for k, _ in tckpt.flatten_with_paths({"state": tstate}))
    assert got == want
    assert "state/.params/embed" in got and "state/.step" in got
    assert any(k.startswith("state/.mix_state/.error/") for k in got) \
        == mix_state
    jckpt.save(str(tmp_path / "j"), 10, {"state": jstate}, {"slot": 3})
    tckpt.save(str(tmp_path / "t"), 10, {"state": tstate}, {"slot": 3})
    metas = [open(tmp_path / d / "step_00000010" / "meta.msgpack",
                  "rb").read() for d in ("j", "t")]
    assert metas[0] == metas[1]
    arrays = [np.load(tmp_path / d / "step_00000010" / "arrays.npz")
              for d in ("j", "t")]
    assert sorted(arrays[0].files) == sorted(arrays[1].files) == want
    for key in want:
        np.testing.assert_array_equal(arrays[1][key], arrays[0][key])
        assert arrays[1][key].dtype == arrays[0][key].dtype


@pytest.mark.parametrize("mix_state", [False, True])
def test_checkpoints_cross_packages(tmp_path, mix_state):
    _cross_packages(tmp_path, *_states(mix_state))


def test_moe_checkpoints_cross_packages(tmp_path):
    """A dense layer and an MoE layer (router, expert stacks, shared
    expert): the leaves, keys and bytes cross both ways."""
    moe = dict(TOY, name="toy-ckpt-moe", arch_type="moe", moe_experts=4,
               moe_period=2, moe_shared_expert=True)
    jstate, tstate = _states(False, moe)
    keys = [k for k, _ in tckpt.flatten_with_paths({"state": tstate})]
    assert "state/.params/layers/1/moe/w_gate" in keys
    assert "state/.params/layers/0/ffn/w_gate" in keys
    assert sorted(keys) == _jax_keys({"state": jstate})
    _cross_packages(tmp_path, jstate, tstate)


def _cross_packages(tmp_path, jstate, tstate):
    md = {"step": 10, "algorithm": "dspg", "loader": None}
    # the reference saves, the port restores
    jckpt.save(str(tmp_path / "j"), 10, {"state": jstate}, md)
    back, step, meta = tckpt.restore(str(tmp_path / "j"), {"state": tstate})
    assert (step, meta) == (10, md)
    for (k, want), (k2, got) in zip(
            tckpt.flatten_with_paths({"state": tstate}),
            tckpt.flatten_with_paths(back)):
        assert k == k2 and isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the port saves, the reference restores
    tckpt.save(str(tmp_path / "t"), 20, {"state": tstate}, md)
    jback, step, meta = jckpt.restore(str(tmp_path / "t"), {"state": jstate})
    assert (step, meta) == (20, md)
    for want, got in zip(jax.tree.leaves({"state": jstate}),
                         jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("tdtype,mldtype,nan", [
    (torch.bfloat16, ml_dtypes.bfloat16, 0x7FC0),
    (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn, 0x7F),
    (torch.float8_e5m2, ml_dtypes.float8_e5m2, 0x7E)])
def test_view_dtype_leaves_round_trip_and_cross(tmp_path, tdtype, mldtype,
                                                nan):
    """Leaves numpy has no dtype for are stored as unsigned views, their
    dtype named in the metadata, bit for bit in both packages."""
    width = torch.empty((), dtype=tdtype).element_size()
    udt, sdt = np.dtype(f"u{width}"), np.dtype(f"i{width}")
    bits = np.random.default_rng(1).integers(0, 2 ** (8 * width),
                                             size=(3, 5)).astype(udt)
    bits[0, 0] = nan                             # a NaN keeps its bits too
    t = torch.from_numpy(bits.view(sdt)).view(tdtype)
    tree = {"w": t, "f": torch.arange(4.0), "n": None}
    tckpt.save(str(tmp_path / "t"), 1, tree)
    back, _, _ = tckpt.restore(str(tmp_path / "t"), tree)
    assert back["w"].dtype == tdtype and back["n"] is None
    assert np.array_equal(back["w"].view(torch.uint8).numpy(),
                          t.view(torch.uint8).numpy())
    # the reference reads the port's leaf, and the port the reference's
    jtree = {"w": bits.view(mldtype), "f": np.arange(4.0)}
    jback, _, meta = jckpt.restore(str(tmp_path / "t"), jtree)
    assert jback["w"].dtype == mldtype
    np.testing.assert_array_equal(jback["w"].view(udt), bits)
    jckpt.save(str(tmp_path / "j"), 1, {"w": jnp.asarray(jtree["w"]),
                                        "f": jnp.arange(4.0)})
    assert open(tmp_path / "j" / "step_00000001" / "meta.msgpack",
                "rb").read() == open(tmp_path / "t" / "step_00000001" /
                                     "meta.msgpack", "rb").read()
    back, _, _ = tckpt.restore(str(tmp_path / "j"), tree)
    assert np.array_equal(back["w"].view(torch.uint8).numpy(),
                          t.view(torch.uint8).numpy())


def test_leaf_shape_reads_the_header(tmp_path):
    tckpt.save(str(tmp_path), 3, {"state": {"embed": np.zeros((4, 6, 2))}})
    path = str(tmp_path / "step_00000003" / "arrays.npz")
    assert tckpt.leaf_shape(path, "state/embed") == (4, 6, 2)
    assert tckpt.leaf_shape(path, "state/nope") is None


# ---------------------------------------------------------------------------
# the directory discipline, as the reference's tests hold it
# ---------------------------------------------------------------------------

PACKAGES = {"jax": (jckpt, lambda a: jnp.asarray(a)),
            "torch": (tckpt, lambda a: torch.as_tensor(a))}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_keep_last_prunes_old_steps(tmp_path, pkg):
    ckpt, arr = pkg
    d = str(tmp_path / "ckpt")
    tree = {"w": arr(np.ones(2, np.float32))}
    for step in (10, 20, 30):
        ckpt.save(d, step, tree, keep_last=2)
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == ["step_00000020", "step_00000030"]
    _, step, _ = ckpt.restore(d, tree)
    assert step == 30
    ckpt.save(d, 40, tree)                      # None keeps everything
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 3
    with pytest.raises(ValueError, match="keep_last"):
        ckpt.save(d, 50, tree, keep_last=0)


def test_orphan_tmpdirs_are_swept(tmp_path, pkg):
    ckpt, arr = pkg
    d = str(tmp_path / "ckpt")
    tree = {"w": arr(np.ones(2, np.float32))}
    ckpt.save(d, 1, tree)
    orphan = os.path.join(d, ".tmp_ckpt_dead")
    os.makedirs(orphan)
    open(os.path.join(orphan, "arrays.npz"), "wb").close()
    ckpt.save(d, 2, tree)
    assert not os.path.exists(orphan)
    assert ckpt.latest_step(d) == 2


def test_stray_step_names_are_ignored(tmp_path, pkg):
    ckpt, arr = pkg
    d = str(tmp_path / "ckpt")
    tree = {"w": arr(np.ones(2, np.float32))}
    ckpt.save(d, 10, tree, keep_last=2)
    os.makedirs(os.path.join(d, "step_notes"))
    open(os.path.join(d, "step_10_copy"), "w").close()
    assert ckpt.latest_step(d) == 10
    ckpt.save(d, 20, tree, keep_last=2)
    ckpt.save(d, 30, tree, keep_last=2)
    names = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    assert names == ["step_00000020", "step_00000030", "step_10_copy",
                     "step_notes"]
    assert ckpt.latest_step(d) == 30


def test_shape_mismatch_and_missing_dir_raise(tmp_path, pkg):
    ckpt, arr = pkg
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 1, {"w": arr(np.ones(3, np.float32))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, {"w": arr(np.ones(4, np.float32))})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), {"w": arr(np.ones(1))})
    assert ckpt.latest_step(str(tmp_path / "nope")) is None


def test_flatten_and_save_release_the_leaves_without_the_collector(tmp_path):
    """A save must not keep the tree's tensors alive in a reference cycle:
    on the card those are the train state's gigabytes, which a snapshot
    refresh right after a checkpoint needs back."""
    import gc
    import weakref
    leaf = torch.ones(8)
    ref = weakref.ref(leaf)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        tckpt.flatten_with_paths({"state": {"a": [leaf]}})
        tckpt.save(str(tmp_path), 1, {"state": {"a": [leaf]}})
        del leaf
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()
