"""The device index stream (``core.device_sampling``) across ranks, and its
statistical quality.

A node-sharded run with ``sampling="device"`` draws only its rows of the
stream (``IndexStream(rows=...)``).  The index of node ``i``'s ``j``-th
sample at step ``t`` is a pure function of ``(key, stream, t, i, j)``, so
each rank's rows equal those rows of the whole draw: checked for m = 8 over
2 and 4 ranks.

Beside it, the properties a probe of the stream found (ROADMAP Queue 3,
"Owed check"), pinned so that an edit of the hash cannot lose them
unseen: at n = 6,250, m = 8, bsz 32 over 4,000 steps (1,024,000 draws)
the counts per index fit the uniform law (chi^2 / dof within 0.1 of 1,
where its standard deviation is 0.018), the correlations across nodes,
steps and lanes are below 0.01 (their standard deviation is about 0.003),
and keys one bit apart, like the two streams of one key, draw equal
indices at the 1 / n rate.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.device_sampling import IndexStream

N, M, BSZ, STEPS = 6250, 8, 32, 4000
KEY = 12345


def _draw(key=KEY, stream=0, rows=slice(None), steps=STEPS):
    s = IndexStream(key, m=M, bsz=BSZ, n=N, device="cpu", stream=stream,
                    rows=rows)
    return s(torch.arange(1, steps + 1, dtype=torch.int64)).numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_a_ranks_rows_equal_those_rows_of_the_whole_draw(world):
    whole = _draw(steps=50)
    per = M // world
    for rank in range(world):
        rows = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(_draw(rows=rows, steps=50),
                                      whole[:, rows])


@pytest.fixture(scope="module")
def draws():
    return _draw()                      # (steps, m, bsz)


def test_counts_fit_the_uniform_law(draws):
    counts = np.bincount(draws.ravel(), minlength=N)
    expected = draws.size / N
    chi2_dof = float(((counts - expected) ** 2 / expected).sum() / (N - 1))
    assert abs(chi2_dof - 1.0) < 0.1, chi2_dof


def _corr(a, b) -> float:
    return float(np.corrcoef(a.ravel().astype(np.float64),
                             b.ravel().astype(np.float64))[0, 1])


def test_nodes_steps_and_lanes_are_uncorrelated(draws):
    across_nodes = max(abs(_corr(draws[:, i], draws[:, i + 1]))
                       for i in range(M - 1))
    across_steps = abs(_corr(draws[:-1], draws[1:]))
    across_lanes = max(abs(_corr(draws[:, :, j], draws[:, :, j + 1]))
                       for j in range(BSZ - 1))
    assert across_nodes < 0.01, across_nodes
    assert across_steps < 0.01, across_steps
    assert across_lanes < 0.01, across_lanes


def test_nearby_keys_and_streams_draw_independently(draws):
    rate = 1.0 / N
    for other in (_draw(key=KEY ^ 1), _draw(stream=1)):
        equal = float(np.mean(other == draws))
        assert 0.5 * rate < equal < 2.0 * rate, equal
