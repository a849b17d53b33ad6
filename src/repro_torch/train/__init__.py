"""The decentralized LM trainer of the port (``repro.train``): the
paper's DPSVRG / DSPG update as the data-parallel training rule of the
model zoo.

* :mod:`.steps` — ``TrainState``, ``build_train_step`` (per-node gradients
  under ``torch.func.vmap``; sharded state over a mesh with ``plan=``/
  ``mesh=``), ``build_serve_steps``,
* :mod:`.sharding` — ``MeshPlan`` and the specs of parameters, batches and
  caches, and their DTensor placements,
* :mod:`.trainer` — ``TrainerConfig``, ``train_loop`` (host loop and
  resident path, window starts drawn on the host or on the device,
  checkpoints and bitwise resume) and ``train_sweep`` (a λ/α grid of
  cells as one resident program),
* :mod:`.tracker` — metrics sinks,
* :mod:`.evaluate` — held-out perplexity of the consensus and of each node.
"""

from . import evaluate, sharding, steps, tracker, trainer

__all__ = ["evaluate", "sharding", "steps", "tracker", "trainer"]
