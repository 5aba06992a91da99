"""What decides `correct` can say no. At the tiny size on the CPU: the
control (the reference in the precision below the configuration's) reads
well above the program, and a run with a fault planted under its timed path
(portbench.faults) comes out not correct, for every fault the cell can have:
a decode step that never writes its cache or an optimizer that never updates
(state left unchanged), half of the batch left out, a token altered where it
is produced. (One chip: no exchange between chips to leave out.) On the card
the same readings at the cells' own sizes come from
`python3 -m portbench.control`."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import control, faults
from portbench.tests import tiny


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_reads_far_above_the_program(cell):
    spec = dict(copy.deepcopy(tiny.CELLS[cell]), name=cell)
    r = control.readings(cell, 6, 4.0, torch.device("cpu"), spec=spec, cfg_file=tiny.CFG_FILE)
    # the control fails at least one number, by three times the program's reading
    assert any(r["control"][n] > max(3 * r["numbers"][n], spec["checks"][n]["limit"])
               for n in r["numbers"]), r


CASES = [(cell, f) for cell in ("tiny-caption", "tiny-sampled") for f in faults.SERVING] + \
        [("tiny-train", f) for f in faults.TRAINING]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    table = faults.TRAINING if cell == "tiny-train" else faults.SERVING
    with table[fault]():
        out = tiny.run(cell)
    assert out["correct"] is False, out["checks"]
