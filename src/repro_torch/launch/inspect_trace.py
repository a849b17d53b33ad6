"""Trace inspector: where a step's device time and collective bytes go.

The counterpart of ``repro.launch.inspect_hlo``, which reads the HLO of a
compiled step; the port has no HLO, so this reads what a step did: a
Chrome trace written by ``torch.profiler``'s ``export_chrome_trace``
(record with ``record_shapes=True`` for the collectives' bytes).  It
prints

  * the top-K device kernels by total time, with their count and mean (on
    a trace without device kernels, a CPU-only run, the top-K CPU
    operators instead);
  * the top-K collectives by bytes, by ``launch/roofline.py``'s
    conventions.

Each entry shows the innermost ``record_function`` scope it ran under,
where the trace has one: the counterpart of the reference's "entry vs
while-body".  A kernel's scope is the scope around the runtime call that
launched it (joined by the trace's correlation id).

    PYTHONPATH=src python -m repro_torch.launch.inspect_trace trace.json \
        [--top 15]
"""

from __future__ import annotations

import argparse
import bisect
import collections

from .roofline import _comm_records, _group_size, _trace_events

__all__ = ["analyze", "main"]


class _Scopes:
    """The ``record_function`` scopes of each CPU thread, to find the
    innermost one around a time."""

    def __init__(self, events):
        self._by_thread = collections.defaultdict(list)
        for e in events:
            if e.get("cat") == "user_annotation" and "dur" in e:
                self._by_thread[(e.get("pid"), e.get("tid"))].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]))
        for spans in self._by_thread.values():
            spans.sort()

    def around(self, e) -> str:
        """The innermost scope on ``e``'s thread open at ``e``'s start
        (``e`` itself, when it is a scope, left out)."""
        spans = self._by_thread.get((e.get("pid"), e.get("tid")), [])
        ts = float(e.get("ts", 0.0))
        own = (ts, ts + float(e.get("dur", 0.0)), e.get("name"))
        best = None
        for span in spans[:bisect.bisect_right(spans, (ts, float("inf")))]:
            if span[1] >= ts and span != own and (
                    best is None or (span[0], -span[1]) > (best[0], -best[1])):
                best = span
        return best[2] if best else ""


def _timed_rows(events, scopes, cat: str, launcher=None) -> list:
    """Events of ``cat`` grouped by (name, scope): count, total and mean
    microseconds.  ``launcher`` maps a correlation id to the CPU event
    whose scope counts (a kernel's launch)."""
    groups = {}
    for e in events:
        if e.get("cat") != cat or "dur" not in e:
            continue
        where = e
        if launcher is not None:
            where = launcher.get(e.get("args", {}).get("correlation"), {})
        key = (e["name"], scopes.around(where) if where else "")
        g = groups.setdefault(key, {"name": key[0], "scope": key[1],
                                    "count": 0, "total_us": 0.0})
        g["count"] += 1
        g["total_us"] += float(e["dur"])
    rows = sorted(groups.values(), key=lambda r: -r["total_us"])
    for r in rows:
        r["mean_us"] = r["total_us"] / r["count"]
    return rows


def analyze(trace, top: int = 15) -> dict:
    """{"source": "kernels" | "cpu ops", "kernels": top rows, "all_kernels",
    "collectives": top rows, "all_collectives"} of a Chrome trace (a path,
    its parsed dict or its event list).  A collective's group is the
    trace's where it says it, else the default process group's (or 1)."""
    events = _trace_events(trace)
    scopes = _Scopes(events)
    launcher = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = _timed_rows(events, scopes, "kernel", launcher)
    source = "kernels"
    if not kernels:
        kernels = _timed_rows(events, scopes, "cpu_op")
        source = "cpu ops"
    colls = []
    for kind, nbytes, e in _comm_records(events, _group_size(None)):
        a = e.get("args", {})
        colls.append({
            "bytes": nbytes, "kind": kind, "name": e.get("name", ""),
            "type": str(a.get("dtype") or (a.get("Input type") or [""])[0]),
            "dims": a.get("Input Dims", a.get("Out msg nelems", "")),
            "scope": scopes.around(e)})
    colls.sort(key=lambda r: -r["bytes"])
    return {"source": source, "kernels": kernels[:top],
            "all_kernels": kernels, "collectives": colls[:top],
            "all_collectives": colls}


def format_analysis(res: dict) -> str:
    k_all, c_all = res["all_kernels"], res["all_collectives"]
    busy = sum(r["total_us"] for r in k_all)
    lines = [f"{sum(r['count'] for r in k_all)} {res['source']}, "
             f"{busy / 1e3:.3f} ms in all; {len(c_all)} collectives, "
             f"{sum(r['bytes'] for r in c_all) / 2**30:.3f} GiB",
             f"{'total ms':>10} {'count':>7} {'mean us':>10}  scope / name"]
    for r in res["kernels"]:
        lines.append(f"{r['total_us'] / 1e3:10.3f} {r['count']:7d} "
                     f"{r['mean_us']:10.2f}  [{r['scope']}] {r['name'][:100]}")
    if c_all:
        lines.append(f"{'GiB':>9}  {'kind':18} {'type':10} scope / op")
        for r in res["collectives"]:
            lines.append(f"{r['bytes'] / 2**30:9.3f}  {r['kind']:18} "
                         f"{r['type']:10} [{r['scope']}] {r['name']} "
                         f"{r['dims']}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_file")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    res = analyze(args.trace_file, args.top)
    print(format_analysis(res))
    return res


if __name__ == "__main__":
    main()
