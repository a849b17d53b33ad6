"""Where a run lives: the checkout's root, the program's path, the kernel
caches, and the check that no JAX module was loaded."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SRC = ROOT / "src"

# top-level module names that must never be loaded by a run: JAX itself and
# the JAX package the port was made from (``repro``; ``repro_torch`` is the
# port, so names are compared whole, never by prefix)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare() -> None:
    """Put the program on the path and keep every build and kernel cache
    at a fixed directory inside the checkout."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    # the training cell's state and a refresh's activations fill most of
    # the card: a fragmented cache would run out of memory sooner
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    # libraries that load JAX or Flax on their own are told not to
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def single_threaded() -> None:
    """One thread for the numerical libraries' pools, set before they load:
    a run is one process on the card's host, its host work is Python
    dispatch, and idle pool threads spinning beside it only add noise to
    the host's clock."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN)
