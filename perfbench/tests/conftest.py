"""Shared set-up of the benchmark's CPU tests: tiny configurations of the
cells (the program's TINY_64 geometry, narrow widths) run through the plain
paths on the CPU. Tests that need the card take the ``card`` fixture, which
skips them when there is none."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import bench  # noqa: E402

# The program runs float32 with the plain conv stem here (the fused stems
# are kernels of the card), so that a sound run reads 0 in every number and
# a fault shows against nothing.
TINY = dict(dataset="tiny_64", width_mult=0.125, tcb_channels=32, num_classes=4, size=64,
            feature_maps=[8, 4, 2, 1], min_sizes=[8, 16, 32, 48], prefilter_anchors=64,
            precision="fp32", stem="conv")
SMALL_TRAFFIC = dict(snippet_frames=6, pool_per_lane=4, deep_lanes=2, deep_checks=3,
                     shallow_depth=2, lanes=4, warmup_steps=2, trace_steps=3,
                     trace_seconds=0.5)


def tiny_cell(workload: str, **config) -> bench.Cell:
    """The cell ``workload`` of BENCHMARK.json at tiny size, its limits as
    committed."""
    cell = bench.find_cell(workload)
    cfg = {**cell.config, **TINY, **config}
    traffic = dict(cell.traffic, **{k: v for k, v in SMALL_TRAFFIC.items() if k in cell.traffic})
    return bench.Cell(workload, cell.chips, cfg, traffic, cell.limits, cell.end_to_end,
                      cell.per_layer)


def workloads():
    return [w["name"] for w in bench.benchmark()["workloads"]]


def config_workloads():
    """(configuration, its first workload) for each configuration of
    BENCHMARK.json."""
    spec = bench.benchmark()
    return [(c["name"], next(w["name"] for w in spec["workloads"] if w["config"] == c["name"]))
            for c in spec["configs"]]


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda")
