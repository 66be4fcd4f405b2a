"""The port's CPU tests run PyTorch on one intra-op thread.

The Tier-1 command (ROADMAP.md) runs the test files in six pytest-xdist
worker processes on a few cores. PyTorch's default intra-op pool has a
thread a core in every worker, so the workers' threads contend for the
cores and the port's many small ops ran up to 100x slower than in one
process. Each tests/test_torch_port_*.py
module imports ``one_torch_thread``, an autouse fixture that sets one
thread for the module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
