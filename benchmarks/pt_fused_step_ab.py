#!/usr/bin/env python3
"""Builds of the fused_step kernel held to each other and timed in turns on
one card.

    python3 benchmarks/pt_fused_step_ab.py --other PATH/fused_step.cu

Builds this checkout's ``src/repro_torch/kernels/fused_update/csrc/
fused_step.cu`` and every ``--other`` source (for example the same file of
the parent commit, unpacked with ``git archive``) with the port's ``nvcc``
flags.  At ``chip_smoke.py``'s ``KERNEL_SHAPES``, at m = 16 and at d in
{30, 8192}, for both rules and the three proxes, it launches each build's
``fused_step_launch`` on the same seeded inputs (alpha from device memory,
as the resident path passes it), holds every result to the plain version
``fused_step_math`` at ``chip_smoke.py``'s tolerance and asserts that all
builds give the same bits, also with alpha by value and on views one
element into their buffers (the scalar path).  It then times each build in
a CUDA graph (``chip_smoke.graph_ms``; each call writes a new output, as
the wrapper's do) in two rounds, the second in reverse order, so that a
drift of the card's clock weighs on every build alike.  Prints one ``fused_step_ab`` JSON line a case: each build's median
ms over its turns, the bound, the launch floor (an empty kernel of this
build, ``floor_ms``) and each build's share of the bound; before them, the
ptxas registers and spills of each build and its instantiation count.
Calls the libraries directly, so no wrapper's launch count moves.  Needs
one card.
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
from repro_torch.kernels.fused_update import kernel as fu_kernel  # noqa
from repro_torch.kernels.fused_update import ref as fu_ref  # noqa: E402

SHAPES = list(chip_smoke.KERNEL_SHAPES) + [(16, 1024), (8, 30), (16, 30),
                                           (8, 8192), (16, 8192)]
ALPHA, LAM = 0.05, 0.01


def bind(source: Path):
    lib = _build.load(source)
    ptr = ctypes.c_void_p
    lib.fused_step_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_longlong, ptr,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ptr]
    lib.fused_step_launch.restype = ctypes.c_int
    return lib


def launcher(lib, w, streams, alpha, rule, prox):
    """A call that launches ``lib``'s kernel into a new output, as the
    wrapper ``ops.fused_step_buf`` does (in a CUDA graph each call then
    writes its own buffer, not one that stays in L2), and returns it."""
    m, d = streams[0].shape
    ptrs = [s.data_ptr() for s in streams] + [None] * (4 - len(streams))
    if isinstance(alpha, torch.Tensor):
        a_ptr, a_val = alpha.data_ptr(), 0.0
    else:
        a_ptr, a_val = None, alpha

    def call(tensors=(w, *streams, alpha)):   # held while it launches
        out = torch.empty_like(streams[0])
        rc = lib.fused_step_launch(
            w.data_ptr(), *ptrs, out.data_ptr(), m, d, a_ptr, a_val, LAM,
            fu_kernel.RULES[rule], fu_kernel.PROXES[prox],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fused_step_launch returned {rc}")
        return out
    return call


def run_all(libs, w, streams, alpha, rule, prox):
    """Each build's output on the same inputs."""
    outs = [launcher(lib, w, streams, alpha, rule, prox)() for lib in libs]
    torch.cuda.synchronize()
    return outs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", action="append", default=[],
                        help="another fused_step.cu to build and time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("pt_fused_step_ab: needs a CUDA card")
    device = torch.device("cuda")
    sources = [fu_kernel.SOURCE] + [Path(p).resolve() for p in args.other]
    for source, log in _build.build(sources).items():
        print(f"--- ptxas: {source} "
              f"({log.count('Compiling entry function')} kernels)\n"
              + "\n".join(ln for ln in log.splitlines()
                          if "Used" in ln or "spill" in ln))
    libs = [bind(s) for s in sources]
    names = ["this"] + args.other
    floor_ms = chip_smoke.graph_ms(lambda: fu_kernel.noop_launch())
    for m, d in SHAPES:
        for rule in fu_ref.FUSED_RULES:
            for prox in fu_ref.FUSED_PROXES:
                w, streams = chip_smoke.kernel_case(m, d, rule, seed=m * d,
                                                    device=device)
                alpha_dev = torch.tensor([ALPHA], dtype=torch.float32,
                                         device=device)[0]
                plain = fu_ref.fused_step_math(w, streams, ALPHA, LAM,
                                               rule=rule, prox_kind=prox)
                # views one element into larger buffers: the scalar path
                shifted = []
                for s in streams:
                    base = torch.empty(s.numel() + 1, device=device)
                    base[1:] = s.reshape(-1)
                    shifted.append(base[1:].view(m, d))
                for alpha, ins in ((alpha_dev, streams), (ALPHA, streams),
                                   (alpha_dev, shifted)):
                    outs = run_all(libs, w, ins, alpha, rule, prox)
                    for name, out in zip(names, outs):
                        torch.testing.assert_close(
                            out, plain, rtol=chip_smoke.KERNEL_RTOL,
                            atol=chip_smoke.KERNEL_ATOL,
                            msg=lambda e: f"{name} {rule} {prox} "
                                          f"{(m, d)}: {e}")
                        if not torch.equal(out, outs[0]):
                            sys.exit(f"pt_fused_step_ab: {name} and this "
                                     f"build differ at {rule} {prox} "
                                     f"{(m, d)}")
                calls = [launcher(lib, w, streams, alpha_dev, rule, prox)
                         for lib in libs]
                turns = [[] for _ in libs]
                for order in (range(len(libs)), reversed(range(len(libs)))):
                    for i in order:
                        turns[i].append(chip_smoke.graph_ms(calls[i]))
                bnd, bnd_by = chip_smoke.fused_bound(m, d, rule, prox)
                ms = {name: statistics.median(t)
                      for name, t in zip(names, turns)}
                print("fused_step_ab " + json.dumps({
                    "shape": [m, d], "rule": rule, "prox": prox, "ms": ms,
                    "bound_ms": bnd, "bound_by": bnd_by,
                    "floor_ms": floor_ms, "bitwise_equal": True,
                    "share_of_bound": {k: bnd / v for k, v in ms.items()}}),
                    flush=True)


if __name__ == "__main__":
    main()
