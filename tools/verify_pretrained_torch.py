"""Pretrained-checkpoint fidelity check across the two packages: the
counterpart of tools/verify_pretrained.py.

No real ``vgg16_reducedfc.pth`` or torchvision ``resnet101`` checkpoint is in
the repository, so the weight converters are proven on synthetic layouts. The
moment a real one is at hand, this script anchors the port's converter to the
JAX package's in one command:

    python tools/verify_pretrained_torch.py --ckpt /path/vgg16_reducedfc.pth
    python tools/verify_pretrained_torch.py --ckpt /path/resnet101.pth --backbone resnet101

It (1) grafts the checkpoint into the port's backbone
(``tdrn_tpu_torch/weights.py::load_vgg_backbone`` / ``load_resnet_backbone``)
and into the JAX package's (``tdrn_tpu/utils/torch_weights.py``), both on the
same seeded draw of the other weights, (2) runs one seeded image through both
backbones and (3) prints one JSON line with each source feature's max|delta|
and its share of the feature's max|.|, which must sit at float noise if both
conversions (OIHW -> HWIO, the BN fold) are faithful. It exits 1 above
``--tolerance`` (relative) and 2 if nothing was grafted. It bridges the two
packages, so it lives outside tdrn_tpu_torch/, and it runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="torch .pth state dict")
    ap.add_argument("--backbone", default="vgg16", choices=["vgg16", "resnet101"])
    ap.add_argument("--size", type=int, default=320, help="the test image's side")
    ap.add_argument("--tolerance", type=float, default=1e-4)
    ap.add_argument("--width_mult", type=float, default=1.0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import jax.numpy as jnp
    import torch

    from tdrn_tpu.models.resnet import ResNetBackbone
    from tdrn_tpu.models.vgg import VGG16Reduced
    from tdrn_tpu.utils import torch_weights as jtw
    from tdrn_tpu_torch import weights
    from tdrn_tpu_torch.config import VID_320, VID_512
    from tdrn_tpu_torch.models.detector import build_detector

    cfg = VID_512 if args.size == 512 else VID_320
    model = build_detector(cfg, backbone=args.backbone, temporal=False,
                           width_mult=args.width_mult, device="cpu")
    weights.load_random_params(model, 0)
    jparams = weights.params_to_jax(model.state_dict())
    if args.backbone == "resnet101":
        jparams, jloaded, _ = jtw.load_resnet_backbone(jparams, args.ckpt)
        _, loaded, report = weights.load_resnet_backbone(model, args.ckpt)
        jbackbone = ResNetBackbone(depth=101, norm="frozen", width_mult=args.width_mult)
    else:
        jparams, jloaded, _ = jtw.load_vgg_backbone(jparams, args.ckpt)
        _, loaded, report = weights.load_vgg_backbone(model, args.ckpt)
        jbackbone = VGG16Reduced(width_mult=args.width_mult)
    print(f"grafted {len(loaded)} tensors into the port, {len(jloaded)} into the JAX "
          f"package; skipped or unmatched: {report}")
    result = {"ckpt": args.ckpt, "backbone": args.backbone, "grafted": len(loaded),
              # The JAX package names a kernel ".kernel" where the port says ".weight".
              "same_grafts": sorted(loaded) == sorted(n.replace(".kernel", ".weight")
                                                      for n in jloaded),
              "sources": []}
    if not loaded:
        print("ERROR: nothing grafted: unrecognized state-dict layout")
        sys.exit(2)

    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (1, args.size, args.size, 3)).astype(np.float32)
    img -= np.asarray(cfg.pixel_means, np.float32)
    jax_sources = jbackbone.apply({"params": jparams["params"]["backbone"]}, jnp.asarray(img))
    model.eval()
    with torch.no_grad():
        port_sources = model.backbone(torch.from_numpy(img))
    worst = 0.0
    for i, (js, ps) in enumerate(zip(jax_sources, port_sources)):
        ps = ps.numpy().transpose(0, 2, 3, 1)
        d = float(np.max(np.abs(np.asarray(js) - ps)))
        rel = d / (float(np.max(np.abs(ps))) + 1e-9)
        result["sources"].append({"scale": i, "shape": list(ps.shape), "max_abs_delta": d,
                                  "rel": rel})
        worst = max(worst, rel)
    result["worst_rel_delta"] = worst
    result["pass"] = bool(result["same_grafts"] and worst <= args.tolerance)
    print(json.dumps(result))
    if not result["pass"]:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
