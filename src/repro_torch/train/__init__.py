"""The decentralized LM trainer of the port (``repro.train``): the
paper's DPSVRG / DSPG update as the data-parallel training rule of the
model zoo.

* :mod:`.steps` — ``TrainState``, ``build_train_step`` (per-node gradients
  under ``torch.func.vmap``), ``build_serve_steps``,
* :mod:`.trainer` — ``TrainerConfig`` and ``train_loop`` (host loop and
  resident path, checkpoints and bitwise resume),
* :mod:`.tracker` — metrics sinks,
* :mod:`.evaluate` — held-out perplexity of the consensus and of each node.

The reference's ``train_sweep`` (a grid of cells in one program) is ROADMAP
Queue 1 item 12 (b); ``sharding`` is multi-device work (item 14).
"""

from . import evaluate, steps, tracker, trainer

__all__ = ["evaluate", "steps", "tracker", "trainer"]
