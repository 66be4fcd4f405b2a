"""Convert a JAX package (orbax) checkpoint into the PyTorch port's layout.

Reads a ``tdrn_tpu`` train directory through its ``CheckpointManager``
(which restores a checkpoint written on another backend), converts the
params with ``tdrn_tpu_torch.weights.params_from_jax`` (int8 QConv weights
stay int8) and writes ``<out>/<step>/params.pt`` with a copy of
``model_meta.json`` (tdrn_tpu_torch/train/checkpoint.py). The one script of
the repo that imports both packages.

    python tools/orbax_to_torch.py --src weights/ --out weights_torch/ [--step N]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src: str, out: str, step=None) -> int:
    """Convert step ``step`` (default the newest) of ``src`` into ``out``;
    returns the step converted."""
    from tdrn_tpu.train.checkpoint import CheckpointManager
    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.train import checkpoint

    if not os.path.isdir(src):
        raise FileNotFoundError(f"no checkpoint directory {src}")
    mgr = CheckpointManager(src)
    try:
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint found in {src}")
        raw = mgr._restore_numpy(int(step))
        meta = mgr.load_meta()
    finally:
        mgr.close()
    checkpoint.save_params(out, int(step), weights.params_from_jax(raw["params"]))
    if meta is not None:
        checkpoint.save_meta(out, meta)
    return int(step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="tdrn_tpu (orbax) checkpoint directory")
    ap.add_argument("--out", required=True, help="tdrn_tpu_torch checkpoint directory")
    ap.add_argument("--step", type=int, default=None, help="step to convert (default: newest)")
    args = ap.parse_args(argv)
    step = convert(args.src, args.out, args.step)
    print(f"converted step {step}: {args.src} -> {args.out}")


if __name__ == "__main__":
    main()
