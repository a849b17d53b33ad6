"""Where ``chip_smoke.py``'s time goes: the script run under a stack sampler.

    python3 benchmarks/pt_smoke_sampler.py [--out PATH] [--interval S]

Runs ``chip_smoke.py`` (from the root of the checkout, as ``python3
chip_smoke.py`` would, on the card) in this process while a thread samples
the main thread's Python stack every ``--interval`` seconds (0.02 by
default).  Each sample charges the time since the previous one (the
interval, or more where the script held the GIL longer) to every function
on the stack (inclusive time, once a sample however deep the recursion)
and to the innermost one (self time).  When the script ends, however it ends, the
report goes to ``--out`` (``build/smoke_profile.txt`` by default):
the repository's functions by inclusive seconds, then any function by self
seconds and by inclusive seconds.  Work in a subprocess the script starts
(``nvcc``, the launchers) shows as the time its caller waits.  The
sampler holds the GIL for a few microseconds a sample; the script's own
output is unchanged.
"""

from __future__ import annotations

import argparse
import collections
import os
import runpy
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key(code) -> str:
    path = code.co_filename
    if path.startswith(ROOT + os.sep):
        path = os.path.relpath(path, ROOT)
    else:
        path = os.path.basename(path)
    return f"{path}:{code.co_firstlineno}:{code.co_name}"


class Sampler(threading.Thread):
    """Samples the stack of the thread that made it until ``stop``."""

    def __init__(self, interval: float):
        super().__init__(daemon=True)
        self.interval = interval
        self.inclusive: collections.Counter = collections.Counter()   # s
        self.own: collections.Counter = collections.Counter()         # s
        self._target = threading.get_ident()
        self._done = threading.Event()

    def run(self) -> None:
        last = time.perf_counter()
        while not self._done.wait(self.interval):
            now = time.perf_counter()
            dt, last = now - last, now
            frame = sys._current_frames().get(self._target)
            seen = set()
            if frame is not None:
                self.own[_key(frame.f_code)] += dt
            while frame is not None:
                key = _key(frame.f_code)
                if key not in seen:
                    seen.add(key)
                    self.inclusive[key] += dt
                frame = frame.f_back

    def stop(self) -> None:
        self._done.set()
        self.join()

    def report(self, top: int = 200) -> str:
        ours = ("chip_smoke.py", "src" + os.sep, "benchmarks" + os.sep,
                "examples" + os.sep)
        lines = ["# inclusive seconds, this repository's functions"]
        lines += [f"{t:9.2f} {k}" for k, t in self.inclusive.most_common()
                  if k.startswith(ours) and t >= 0.5]
        lines += ["", "# self seconds, any function"]
        lines += [f"{t:9.2f} {k}" for k, t in self.own.most_common(top)]
        lines += ["", "# inclusive seconds, any function"]
        lines += [f"{t:9.2f} {k}" for k, t in self.inclusive.most_common(top)]
        return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "smoke_profile.txt"))
    ap.add_argument("--interval", type=float, default=0.02)
    args = ap.parse_args(argv)
    sampler = Sampler(args.interval)
    sampler.start()
    t0 = time.perf_counter()
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    sys.argv = [os.path.join(ROOT, "chip_smoke.py")]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sampler.stop()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(f"# chip_smoke.py under the sampler: "
                     f"{time.perf_counter() - t0:.1f} s, a sample every "
                     f"{args.interval} s\n")
            fh.write(sampler.report())


if __name__ == "__main__":
    main()
