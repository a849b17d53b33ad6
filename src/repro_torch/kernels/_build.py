"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source exposes a plain C interface and compiles on its
own into a shared library for ``sm_90a``.  Libraries go to ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source and the flags, so a changed source rebuilds and an unchanged one
loads the library already built.  Nothing builds when a module is imported:
the wrappers call :func:`load` the first time they launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "library_path", "build",
           "load"]

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def build(sources) -> dict:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together.  Returns ``{source: compiler output}`` for the
    sources built (``-Xptxas -v`` reports registers and shared memory).
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in map(Path, sources):
        target = library_path(source)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[source] = (proc, tmp, target)
    logs, failed = {}, []
    for source, (proc, tmp, target) in jobs.items():
        logs[source] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(source)
            os.unlink(tmp)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {s}\n{logs[s]}" for s in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The shared library of ``source``, built on first use."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
