"""Render the roofline table from the dry run's JSON rows.

The port of ``repro.launch.make_table``: the reference's columns, with
"compile s" (XLA's compile time) renamed "build s", the seconds the port's
dry run took to build and count the row on the meta device.  Every number
is computed from shapes at the H100 SXM's published rates, not measured.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --out dry.json
    PYTHONPATH=src python -m repro_torch.launch.make_table dry.json \
        > roofline_table.md
"""

from __future__ import annotations

import glob
import json
import sys


def load_rows(patterns):
    rows = []
    for pat in patterns:
        for path in sorted(glob.glob(pat)):
            with open(path) as f:
                rows.extend(json.load(f))
    return rows


def fmt_ms(x):
    return f"{x * 1e3:.2f}"


def render(rows) -> str:
    """The table, its count line and the skips and errors, as markdown."""
    ok = [r for r in rows if r.get("status") == "ok"]
    skipped = [r for r in rows if r.get("status") == "skipped"]
    errors = [r for r in rows if r.get("status") == "error"]
    out = ["## Roofline table (per (arch x shape x mesh); terms in ms/step)\n",
           "| arch | shape | mesh | kind | t_compute | t_memory | t_collective"
           " | bottleneck | useful (6ND/analytic) | coll GB/dev | mem GB/dev"
           " (args) | build s |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    key = lambda r: (r["arch"], r["shape"], r["mesh"])
    for r in sorted(ok, key=key):
        bpd = (r.get("bytes_per_device") or 0) / 1e9
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('kind','')} "
            f"| {fmt_ms(r['t_compute'])} | {fmt_ms(r['t_memory'])} "
            f"| {fmt_ms(r['t_collective'])} | **{r['bottleneck']}** "
            f"| {r['useful_ratio']:.3f} | {r['coll_gbytes']:.2f} "
            f"| {bpd:.1f} | {r.get('build_s','')} |")
    out.append(f"\n{len(ok)} counted, {len(skipped)} documented skips, "
               f"{len(errors)} errors.")
    if skipped:
        out.append("\nSkips:")
        for r in skipped:
            out.append(f"- {r['arch']} x {r['shape']} ({r['mesh']}): "
                       f"{r['reason']}")
    if errors:
        out.append("\nERRORS:")
        for r in errors:
            out.append(f"- {r['arch']} x {r['shape']} ({r['mesh']}): "
                       f"{r['error']}")
    return "\n".join(out)


def main(argv=None):
    patterns = (sys.argv[1:] if argv is None else argv) or ["dryrun_*.json"]
    rows = load_rows(patterns)
    print(render(rows))
    if any(r.get("status") == "error" for r in rows):
        sys.exit(1)


if __name__ == "__main__":
    main()
