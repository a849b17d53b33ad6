"""CUDA-graph replays a grid makes: the program's ``extras["replays"]``
(``core/runner.py``, ``core/cuda_graphs.py``), one a piece of steps.
Fewer, longer pieces mean fewer host round trips.  Moves
``logreg_epochs_per_s``."""

READS = ("program counter extras['replays']",)


def read(ctx):
    value = ctx["counters"].get("replays")
    return None if not value else value
