"""The readings that a cell's limits are set from, on the chip.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3

For each seed, the weights and inputs of a run with that seed, and the
reference in the program's place twice: in float32, and as the control,
with both operands of every bf16 convolution rounded to float8 e4m3 (the
precision below the configuration's bf16). The control is compared with
the float32 reference as a run compares the program; one JSON line a seed.

The checked snippets are those of a run that went on past two snippets on
every stream. The program's own readings are those of its runs
(perfbench/run.py), and those of the faults planted in it
(perfbench/faults.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from perfbench import bench, streams  # noqa: E402
from perfbench.reference import fp8  # noqa: E402


def control_readings(cell, seed: int, device, lowp=fp8) -> dict:
    cfg, traffic = cell.config, cell.traffic
    lanes = int(traffic["lanes"])
    pool = bench.frame_pool(seed, lanes, int(traffic["pool_per_lane"]), cfg["size"], device)
    weights = bench.make_weights(cfg, seed, device)
    strm = streams.Streams(pool, traffic["snippet_frames"], traffic["stagger"])
    ring = streams.Ring(lanes, 2 * strm.snippet + 8, int(cfg["top_k"]))
    last = 2 * strm.snippet + 37
    for lane in range(lanes):
        for i in range(last - ring.keep + 1, last + 1):
            ring.put(lane, i, None)
    return streams.check(cfg, weights, strm, ring, traffic, seed, device, lowp=lowp)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = {"control": control_readings(cell, seed, torch.device("cuda"))}
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
