"""On the card, at each cell's own size: the program's output is correct
on three seeds, and the control and each planted fault are not
(`control.readings`: one set-up, short windows at the cell's load).
Skips without a card.  Run on the card with
`python3 -m pytest -m gpu portbench/tests`."""
import pytest
import torch

import control
import run as bench
from pbcore import spec

SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in spec.benchmark()["workloads"]])
def test_control_and_faults_fail_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU "
                    "mode here (run with `pytest -m gpu` on the card)")
    c = spec.load_cell(cell)
    seen = {}
    for seed, mode, checks in control.readings(c, SEEDS, 3.0):
        seen.setdefault(mode, []).append(bench.correct_of(checks))
    assert seen["program"] == [True] * len(SEEDS)
    for mode, ok in seen.items():
        if mode != "program":
            assert ok == [False] * len(SEEDS), mode
