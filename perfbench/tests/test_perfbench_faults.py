"""A run with the timed path broken underneath comes out not correct, under
each cell's committed limits, for each fault the cell can have; so does the
control (the reference at float8 in the program's place). Tiny size, CPU;
the harness's look for a card is skipped."""

import pytest
import torch

from perfbench import control, faults, run
from perfbench.tests.conftest import tiny_cell, workloads

def held(workload):
    """The faults a cell's limits hold: the prefilter only where the whole
    selection (``selection_miss``) is compared (PERF.md)."""
    compared = tiny_cell(workload).limits
    return [f for f in sorted(faults.FAULTS)
            if f != "prefilter_off" or "selection_miss" in compared]


@pytest.mark.parametrize("workload,fault", [(w, f) for w in workloads() for f in held(w)])
def test_serving_fault_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        res = run.run_cell(tiny_cell(workload), 11, 1.0, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", workloads())
def test_sound_run_reads_zero_at_tiny(workload):
    """Float32 on both sides: every number reads 0."""
    res = run.run_cell(tiny_cell(workload), 11, 1.0, False, device="cpu")
    assert all(res["checked"][k] == 0.0 for k in ("selection_miss", "nms_overlap")), res["checked"]
    assert res["checked"]["frame_gap"] < 1e-5


@pytest.mark.parametrize("workload", workloads())
def test_serving_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    got = control.control_readings(cell, 11, torch.device("cpu"))
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)


def test_faults_are_undone():
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.ops import detection, nms

    before = (StreamingDetector.detect, StreamingDetector._commit, nms.suppress_sorted,
              detection._prefilter_on)
    for fault in faults.FAULTS.values():
        with fault():
            pass
    assert before == (StreamingDetector.detect, StreamingDetector._commit, nms.suppress_sorted,
                      detection._prefilter_on)
