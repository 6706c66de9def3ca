"""The control on the card at each cell's own size: three seeds of a cell,
each a run with a short window; the program's numbers pass the cell's
limits and the control's (``run.CONTROL``, the reference in float8
operands in the program's place, on the same samples) fail them.

On a host with the cards: ``python -m pytest benchmark/tests -q -m gpu``.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, run
from conftest import BENCH

CELLS = [(w["name"], w["chips"]) for w in run.load_spec(BENCH)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload, chips", CELLS)
def test_the_control_fails_where_the_program_passes(workload, chips):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    limits = compare.load_limits(BENCH, workload)
    for seed in (20261017, 20261018, 20261019):
        r = run.run_cell(workload, seed, 3.0, False, control=True)
        assert r["correct"], (seed, r["check"])
        assert not compare.judge(r["control"][run.CONTROL], limits, 0)[0], (seed, r["control"])
