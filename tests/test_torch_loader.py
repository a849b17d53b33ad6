"""The port's data loaders against the JAX package's (``repro.data.
loader``): numpy code, so draws, gathers and cursors are held bit for bit
on the same numpy inputs, including after a ``load_state_dict`` round trip
in either direction."""

import json

import numpy as np
import pytest

from repro.data import loader as jloader
from repro_torch.data import loader as tloader

TOKENS = np.random.default_rng(0).integers(0, 512, size=5003).astype(
    np.int32)


def _pair(**kw):
    args = dict(num_nodes=4, per_node_batch=3, seq_len=16, seed=5)
    args.update(kw)
    return jloader.LMLoader(TOKENS, **args), tloader.LMLoader(TOKENS, **args)


@pytest.mark.parametrize("nodes,batch,seq,seed", [(4, 3, 16, 5), (3, 1, 7, 0),
                                                  (8, 2, 32, 11)])
def test_lm_loader_draws_and_gathers_equal_the_reference(nodes, batch, seq,
                                                         seed):
    ja, ta = _pair(num_nodes=nodes, per_node_batch=batch, seq_len=seq,
                   seed=seed)
    assert (ta.shard_len, ta.max_start) == (ja.shard_len, ja.max_start)
    np.testing.assert_array_equal(ta.stacked_shards(), ja.stacked_shards())
    assert ta.stacked_shards().dtype == np.int32
    for _ in range(3):
        for want, got in zip(ja.sample(), ta.sample()):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        starts = ja.sample_starts(4 * batch)
        np.testing.assert_array_equal(ta.sample_starts(4 * batch), starts)
        for want, got in zip(ja.gather(starts), ta.gather(starts)):
            np.testing.assert_array_equal(got, want)
    assert ta.state_dict() == ja.state_dict()


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_lm_loader_cursor_crosses_packages(direction):
    ja, ta = _pair()
    src, dst_cls = (ja, tloader) if direction == "reference_to_port" \
        else (ta, jloader)
    src.sample()
    cursor = json.loads(json.dumps(src.state_dict()))   # metadata-safe
    want = [src.sample() for _ in range(3)]
    dst = dst_cls.LMLoader(TOKENS, num_nodes=4, per_node_batch=3, seq_len=16,
                           seed=999)
    dst.load_state_dict(cursor)
    for (wt, wl) in want:
        gt, gl = dst.sample()
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
    assert dst.state_dict() == src.state_dict()


def test_lm_loader_refuses_short_shards_as_the_reference():
    for pkg in (jloader, tloader):
        with pytest.raises(ValueError, match="seq_len"):
            pkg.LMLoader(np.arange(64, dtype=np.int32), num_nodes=4,
                         per_node_batch=2, seq_len=16)


def test_node_batcher_equals_the_reference():
    rng = np.random.default_rng(1)
    data = {"x": rng.normal(size=(4, 10, 3)).astype(np.float32),
            "y": rng.integers(0, 2, size=(4, 10)).astype(np.float32)}
    jb = jloader.NodeBatcher(data, batch_size=5, seed=7)
    tb = tloader.NodeBatcher(data, batch_size=5, seed=7)
    assert (tb.m, tb.n) == (jb.m, jb.n)
    for _ in range(3):
        want, got = jb.sample(), tb.sample()
        for k in data:
            np.testing.assert_array_equal(got[k], want[k])
