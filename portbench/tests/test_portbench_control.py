"""The control on the card: the reference computed with TF32 matmuls in
the port's place fails a number of every cell, at the cell's own size,
over one tile or two steps. Marked ``cuda``: TF32 exists only there."""

import pytest

from portbench import run
from portbench.tests.conftest import SEED, WORKLOADS


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_check(workload, cuda_device):
    cell = run.load_cell(workload)
    limits = cell.traffic["check"]["limits"]
    control = run.member(run.family(cell.config["model"]), "CONTROLS",
                         cell.traffic["loop"])
    units = 1 if cell.traffic["loop"] == "lookahead_tiles" else 2
    nums = control(cell, SEED, cuda_device, units)
    assert any(v > limits[k] for k, v in nums.items()), nums
