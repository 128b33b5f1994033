"""The control comes out as not correct: the plain reference computed in
bfloat16 (each product's operands and gradients rounded to bfloat16),
the precision below the float32 the configurations state, put in the
program's place, fails a limit of each cell, while the program passes
them all. On the card, at each cell's own size, one seed a cell
(`python3 -m portbench.calibrate` reads more)."""

from __future__ import annotations

import pytest
import torch

from portbench import compare, run, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    res = run.run(cell, 2 ** 31 + 7, 3.0, False, controls=True, log=lambda s: None)
    limits = spec.load_limits(cell)
    assert res["correct"], res["checks"]
    assert not compare.judge(res["controls"], limits)[0], res["controls"]
