"""Table I: dataset geometry (synthetic stand-ins with the paper's shapes).
The port of ``benchmarks/datasets_table.py``; host numpy only."""

from __future__ import annotations

from . import pt_common as common
from repro_torch.data import synthetic


def run(scale: float = 0.02, device="cuda"):
    del device                       # the table is built on the host
    rows = []
    for key, spec in synthetic.PAPER_DATASETS.items():
        ds = synthetic.make_paper_dataset(key, scale=scale)
        rows.append(common.Row(
            f"table1/{key}", 0.0,
            f"paper_n={spec['n']} d={spec['d']} bench_n={ds.n} "
            f"pos_frac={float(ds.labels.mean()):.3f}"))
    return rows
