"""The control on the card: the reference in TF32 in the program's place
fails the cell's numbers (at the tiny shape; `control.py` runs it at the
cells' own sizes)."""

import pytest

from benchmark import control as ctl
from benchmark.harness.cells import load_cell
from conftest import DATA, SEMI5_CELL


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.quick", "tiny.stream", SEMI5_CELL])
def test_control_fails(spec_path, cuda_card, tmp_path, cell):
    c = load_cell(cell, spec_path, DATA / "traffic")
    fails = [ctl.control(c, seed, cuda_card, str(tmp_path))["fails"]
             for seed in (21, 22, 23)]
    assert all(fails), fails
