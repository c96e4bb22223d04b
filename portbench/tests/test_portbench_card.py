"""On the card, at each cell's own size: the control (the reference at the
precision below the stated one in the program's place) reads `correct`
false on three seeds, and the program true. Run on a machine with a CUDA
card: `python -m pytest portbench/tests -m card`."""

import pytest
import torch

from portbench.lib import cells, harness
from portbench.reference.sift_lowe import CONTROLS
from portbench.tests.small import A, B

SEEDS = (2**31 + 11, 2**32 + 5, 4_000_000_019)


@pytest.mark.card
@pytest.mark.parametrize("control", sorted(CONTROLS))
@pytest.mark.parametrize("cell", [A, B])
def test_control_fails_at_cell_size(card, cell, control):
    torch.set_num_threads(1)
    c = cells.resolve(cell)
    judge = cells.load_module("judges", c.step_kind)
    for seed in SEEDS:
        out = harness.run(cell, seed, 0, False, "cuda",
                          steps=c.traffic["check"]["items"],
                          program=lambda inputs: judge.reference(
                              c.config, inputs, CONTROLS[control]))
        assert not out.ok, (seed, out.checks)


@pytest.mark.card
@pytest.mark.parametrize("cell", [A, B])
def test_program_correct_at_cell_size(card, cell):
    torch.set_num_threads(1)
    out = harness.run(cell, SEEDS[0], 2.0, False, "cuda")
    assert out.ok, out.checks
