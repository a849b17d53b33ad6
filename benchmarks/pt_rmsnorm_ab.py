#!/usr/bin/env python3
"""Builds of the RMSNorm kernel timed in turns on one card.

    python3 benchmarks/pt_rmsnorm_ab.py --other PATH/rmsnorm.cu [--other ...]

Builds this checkout's ``src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu``
and every ``--other`` source (for example the same file of the parent
commit, unpacked with ``git archive``) with the port's ``nvcc`` flags.  At
every RMSNorm shape of ``chip_smoke.py`` (rows ``RMS_ROWS`` x widths
``RMS_DIMS``), and at 64 and 133 rows and width 2048 besides, it launches
each build's ``rmsnorm_launch`` on the same seeded input, holds the result
to the plain version ``rmsnorm_ref`` at ``chip_smoke.py``'s tolerances,
and times it in a CUDA graph (``chip_smoke.graph_ms``) in two rounds, the
second in reverse order, so that a drift of the card's clock weighs on
every build alike.  Prints one ``rmsnorm_ab`` JSON line a shape and dtype:
each build's median ms over its turns, the bound and each build's share of
it; before them, the ptxas registers and spills of each build.  Calls the
libraries directly, so no wrapper's launch count moves.  Needs one card.
"""

import argparse
import ctypes
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rn_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402

ROWS = sorted(set(chip_smoke.RMS_ROWS) | {64, 133})
WIDTHS = chip_smoke.RMS_DIMS + [2048]
EPS = 1e-6


def bind(source: Path):
    lib = _build.load(source)
    ptr = ctypes.c_void_p
    lib.rmsnorm_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_float, ctypes.c_int, ptr]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def launcher(lib, x, w, out):
    rows, d = x.shape
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, x.stride(0),
            EPS, rn_kernel.DTYPES[x.dtype])

    def call(tensors=(x, w, out)):     # held while the call can launch
        rc = lib.rmsnorm_launch(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rmsnorm_launch returned {rc}")
    return call


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        help="another rmsnorm.cu to build and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("pt_rmsnorm_ab: needs a CUDA card")
    device = torch.device("cuda")
    sources = [rn_kernel.SOURCE] + [Path(p).resolve() for p in args.other]
    for source, log in _build.build(sources).items():
        print(f"--- ptxas: {source}\n" + "\n".join(
            ln for ln in log.splitlines() if "Used" in ln or "spill" in ln))
    libs = [bind(s) for s in sources]
    names = ["this"] + args.other
    gen = torch.Generator(device=device).manual_seed(7)
    for width in WIDTHS:
        for n in ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                d = width if width != "register+8" else \
                    rn_kernel.max_register_d(dtype) + 8
                x = torch.randn(n, d, generator=gen, device=device).to(dtype)
                w = (0.1 * torch.randn(d, generator=gen, device=device)
                     ).to(dtype)
                plain = rn_ref.rmsnorm_ref(x, w, EPS)
                tol = chip_smoke.RMS_F32_TOL if dtype == torch.float32 \
                    else chip_smoke.RMS_BF16_TOL
                calls = []
                for lib in libs:
                    out = torch.empty_like(x)
                    calls.append(launcher(lib, x, w, out))
                    calls[-1]()
                    torch.cuda.synchronize()
                    torch.testing.assert_close(out, plain, **tol)
                turns = [[] for _ in libs]
                for order in (range(len(libs)), reversed(range(len(libs)))):
                    for i in order:
                        turns[i].append(chip_smoke.graph_ms(calls[i]))
                bnd, _ = chip_smoke.bound(
                    (2 * n * d + d) * x.element_size(), 4 * n * d, dtype)
                ms = {name: statistics.median(t)
                      for name, t in zip(names, turns)}
                print("rmsnorm_ab " + json.dumps({
                    "shape": [n, d], "dtype": str(dtype).split(".")[-1],
                    "ms": ms, "bound_ms": bnd,
                    "share_of_bound": {k: bnd / v for k, v in ms.items()}}),
                    flush=True)


if __name__ == "__main__":
    main()
