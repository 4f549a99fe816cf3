"""On the card: one run of each cell ends correct, and the control (fp8
operands) at the cell's own size is not. Without a card each test skips.

    python -m pytest fedbench/tests/test_fedbench_card.py -q
"""

import pytest
import torch

from fedbench import cell as C
from fedbench import compare, harness
from fedbench.tests.helpers import SEED

CELLS = ("effb0-fedmlp-s1", "r18-fedmlp-s1")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their sizes on the card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = C.load_cell(name)
    trainer, inputs, prog = harness.program_setup(cell, SEED, card)
    del trainer
    ref = harness.reference_rounds(cell, SEED, inputs)
    assert compare.judge(compare.readings(prog, ref, inputs["weights"]), cell.limits)[0]
    ctl = harness.reference_rounds(cell, SEED, inputs, quant=True)
    assert not compare.judge(compare.readings(ctl, ref, inputs["weights"]), cell.limits)[0]
