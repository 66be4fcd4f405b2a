"""The control at each cell's own size, on the card: the reference at float8
in the program's place comes out not correct under the cell's limits.
Skips where there is no card."""

import pytest

from perfbench import bench, control
from perfbench.tests.conftest import workloads


@pytest.mark.parametrize("workload", workloads())
def test_control_fails_at_the_cells_size(workload, card):
    cell = bench.find_cell(workload)
    got = control.control_readings(cell, 2**31 + 101, card)
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)
