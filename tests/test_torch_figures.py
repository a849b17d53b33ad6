"""The port's figure drivers (``benchmarks/pt_*.py``) against the
reference's (``benchmarks/*.py``), on the CPU at ``--scale 0.02``.

Each driver keeps its reference's grid, hyperparameters and derived
columns, so their CSV rows compare field by field: names equal, the
derived numbers within rtol 1e-3 / atol 5e-5 — the printed values (five
decimals for losses and gaps, three digits for oscillations and
consensus) of float32 runs that agree to rtol 1e-4, where a gap (an
objective less F(x*)) keeps the objective's absolute error.  The figures
run through the host loop (the reference's default), and Fig. 4 and Fig. 5
again as batched sweeps through the fused step, whose rows must equal
those of the port's own host loop.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks import (datasets_table, fig4_lambda,  # noqa: E402
                        fig5_connectivity, pt_datasets_table, pt_fig4_lambda,
                        pt_fig5_connectivity)

torch.set_num_threads(1)

SCALE = 0.02
NUMBER = re.compile(r"([A-Za-z_]+)=(-?[0-9.]+(?:e[-+]?[0-9]+)?)")


def _fields(derived: str) -> dict:
    return {k: float(v) for k, v in NUMBER.findall(derived)}


def assert_rows_agree(want, got):
    assert [r.name for r in got] == [r.name for r in want]
    for w, g in zip(want, got):
        fw, fg = _fields(w.derived), _fields(g.derived)
        assert sorted(fg) == sorted(fw), (w.derived, g.derived)
        for k in fw:
            np.testing.assert_allclose(fg[k], fw[k], rtol=1e-3, atol=5e-5,
                                       err_msg=f"{w.name} {k}")


def test_datasets_table_matches_reference():
    want = datasets_table.run(SCALE)
    got = pt_datasets_table.run(SCALE, device="cpu")
    assert [(r.name, r.derived) for r in got] == \
        [(r.name, r.derived) for r in want]


@pytest.mark.parametrize("fig,ref", [("fig4", fig4_lambda),
                                     ("fig5", fig5_connectivity)],
                         ids=["fig4", "fig5"])
def test_figure_rows_match_reference_and_batched_sweeps(fig, ref):
    port = {"fig4": pt_fig4_lambda, "fig5": pt_fig5_connectivity}[fig]
    host = port.run(SCALE, device="cpu")
    assert_rows_agree(ref.run(SCALE), host)
    batched = port.run(SCALE, device="cpu", sweep_batched=True,
                       kernel="fused")
    assert_rows_agree(host, batched)
