"""Run one cell of the benchmark of tdrn_tpu_torch once, on one NVIDIA H100.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell's configuration, traffic and limits
are found by the names in BENCHMARK.json (perfbench/bench.py). A run draws
its weights and frames from the seed on the card, builds and warms the
program (set-up), drives the traffic for ``--seconds`` (the window), reads
the card's memory peak, frees the program and holds what the window
produced against the plain reference (perfbench/reference). With
``--trace 1`` a bounded stretch of the window runs under torch.profiler
and the cell's per-layer metrics are reported instead of its end-to-end
ones. The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tdrn_tpu")


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's nvcc builds go to build/tdrn_tpu_torch on their own)."""
    base = os.path.join(ROOT, "build", "perfbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def loaded_forbidden():
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell, the run's arguments, and the hooks that
    mark the set-up's end, the window's close and the program's release."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.setup_s = None
        self.memory_peak = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        """Called before the program is built: the peak is the program's."""
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def start_window(self) -> None:
        self.setup_s = time.monotonic() - T_START

    def end_window(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = int(self.torch.cuda.max_memory_allocated())

    def free_program(self) -> None:
        """After the window: the program's memory goes back; the reference
        runs in float32 with TF32 off."""
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
            self.torch.cuda.empty_cache()
        self.torch.backends.cuda.matmul.allow_tf32 = False
        self.torch.backends.cudnn.allow_tf32 = False


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    """One run of a cell: the result line's fields (``device`` left to the caller)."""
    from perfbench import bench

    ctx = Context(cell, seed, seconds, trace, device)
    out = bench.driver(cell.traffic).run(ctx)
    checks = out["checks"]
    compared = {k: {"value": checks[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = (out["failed"] == 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    record = dict(out["record"], setup_s=ctx.setup_s, window_s=seconds, chips=cell.chips)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = bench.reader(m["name"]).read(m["name"], record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["end_to_end"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "setup_s": ctx.setup_s,
              "metrics": metrics, "memory_peak_bytes": ctx.memory_peak,
              "profile": record.get("profile"), "checked": checks, "checks": compared}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)

    import torch

    from perfbench import bench

    cell = bench.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"perfbench: {card()}", file=sys.stderr)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: modules of {bad} were loaded in this process", file=sys.stderr)
        return 3
    profile = res.pop("profile")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": res.pop("memory_peak_bytes")}
    if args.trace:
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device}
    if args.trace:
        line["breakdown"] = profile["breakdown"]
    print(f"perfbench: setup_s {res['setup_s']!r}, checked {json.dumps(res['checked'])}",
          file=sys.stderr)
    line["checks"] = res["checks"]
    for name, v in res["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
