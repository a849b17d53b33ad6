"""Minibatch indices drawn on the run's device: the ``sampling="device"``
stream of the resident paths (``runner.run``, ``run_sweep``,
``train_loop``).

The reference threads a ``jax.random`` key through its compiled chunks and
splits it once a step.  The port draws from a counter-based stream instead:
the index of node ``i``'s ``j``-th sample at step ``t`` is a pure function
of ``(key, stream, t, i, j)``, an integer hash computed with int64 tensor
operations and reduced mod ``n``.  So

* the CPU and the card draw the same indices, and a run on the card is held
  to the same run on the CPU at float32 tolerance, as on every other path;
* the step number is a tensor the plan stages, so a CUDA graph of a piece
  draws the right indices at every replay;
* the indices do not depend on how a chunk is cut into pieces;
* a resume needs only the key and the step number.

The stream differs from ``jax.random``'s, as the reference's own device
stream differs from its host one: runs are held to host-sampled runs at the
level of convergence, and to each other (same seed) exactly.

The hash is the 32-bit xorshift-multiply mixer :func:`mix32` applied once
to the step and once to the sample's lane ``i * bsz + j``, each time after
an xor with the previous hash, starting from the mixed key.  Its multiplier
is below 2^27, so no product of a 32-bit value overflows int64.
"""

from __future__ import annotations

import torch

__all__ = ["mix32", "trainer_key", "IndexStream"]

M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B


def mix32(x):
    """A 32-bit integer mixer, for Python ints and int64 tensors holding
    values in [0, 2^32)."""
    x = ((x >> 16) ^ x) * _MUL & M32
    x = ((x >> 16) ^ x) * _MUL & M32
    return (x >> 16) ^ x


def trainer_key(seed: int) -> int:
    """The LM trainer's key, from ``TrainerConfig.seed`` (the reference
    folds 1 into ``PRNGKey(seed)``)."""
    return mix32((int(seed) & M32) ^ mix32(1)) & 0x7FFFFFFF


class IndexStream:
    """``stream(steps) -> indices`` in ``[0, n)``.

    ``keys`` is one key (an int) or one key a sweep cell (a sequence);
    ``steps`` an int64 tensor of step numbers on ``device``, shape
    ``(T,)``.  The result is ``(T, m, bsz)``, or ``(T, cells, m, bsz)`` for
    a sequence of keys.  ``stream`` tells apart two draws of one step (the
    LM trainer's minibatch and snapshot windows).  ``rows`` (a slice of
    the m nodes) draws only those nodes' indices, equal to those rows of
    the whole draw: a node-sharded rank's share."""

    def __init__(self, keys, *, m: int, bsz: int, n: int, device,
                 stream: int = 0, rows: slice = slice(None)):
        keys = torch.as_tensor(keys, dtype=torch.int64, device=device)
        self._key = mix32(mix32(keys & M32) ^ stream)
        self._lane = torch.arange(m * bsz, dtype=torch.int64,
                                  device=device).reshape(m, bsz)[rows]
        self.n = int(n)

    def __call__(self, steps: torch.Tensor) -> torch.Tensor:
        s = steps.reshape(steps.shape + (1,) * self._key.ndim)
        h = mix32((s & M32) ^ self._key)
        return mix32(h[..., None, None] ^ self._lane) % self.n
