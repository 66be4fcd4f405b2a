"""On the card, at each cell's own size: a short run with the carry never
written back, and one with the per-class suppression left out, come out not
correct under the cell's limits. Skips where there is no card."""

import pytest

from perfbench import bench, faults
from perfbench.tests.conftest import workloads


@pytest.mark.parametrize("fault", ["state_unchanged", "nms_off"])
@pytest.mark.parametrize("workload", workloads())
def test_fault_fails_at_the_cells_size(workload, fault, card):
    got = faults.reading(bench.find_cell(workload), fault, 2**31 + 303, 3.0)
    assert not got["correct"], got
