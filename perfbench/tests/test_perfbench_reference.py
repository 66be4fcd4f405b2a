"""The plain reference agrees with the program at tiny size on the CPU
(forward, carry, detect tail), and the yardstick's formulas
give PERF.md's kernel bounds."""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench import bench, roofline
from perfbench.reference import detect as ref_detect
from perfbench.tests.conftest import config_workloads, tiny_cell

CPU = torch.device("cpu")


def tiny(workload: str):
    cfg = tiny_cell(workload).config
    weights = bench.make_weights(cfg, 7, CPU)
    model = bench.load_weights(bench.build_model(cfg, CPU), weights)
    frames = torch.from_numpy(bench.frame_pool(7, 2, 3, cfg["size"], CPU))
    return cfg, weights, model, frames


@pytest.mark.parametrize("config,workload", config_workloads())
def test_forward_and_carry_agree(config, workload):
    from tdrn_tpu_torch.ops.preprocess import preprocess_batch

    cfg, weights, model, frames = tiny(workload)
    ref_model = bench.reference(cfg)
    state, ref_state = model.zero_state(2), ref_model.zero_state(cfg, 2, CPU)
    with torch.no_grad():
        for t in range(3):  # three frames: the carry, not only one forward
            preds, state = model(preprocess_batch(frames[t], model.cfg), state)
            ref_preds, ref_state = ref_model.forward(
                cfg, weights, ref_model.preprocess(cfg, frames[t]), ref_state)
    for got, want in zip(list(preds) + list(state), list(ref_preds) + list(ref_state)):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-7


def test_detect_tail_agrees():
    from tdrn_tpu_torch.ops.detection import detect_topk
    from tdrn_tpu_torch.ops.priors import prior_boxes

    cfg, weights, model, frames = tiny("vgg16_vid320.clips16_ahead")
    with torch.no_grad():
        preds, _ = model(bench.reference(cfg).preprocess(cfg, frames[0]).permute(0, 2, 3, 1),
                         model.zero_state(2))
    pcfg = dataclasses.replace(model.cfg, prefilter_anchors=cfg["prefilter_anchors"])
    got = detect_topk(preds, prior_boxes(pcfg, CPU), pcfg)
    anchors = ref_detect.priors(cfg, CPU)
    assert torch.equal(anchors, prior_boxes(pcfg, CPU))
    boxes, scores, _ = ref_detect.decode(cfg, preds, anchors)
    want = ref_detect.detect(cfg, boxes, scores)
    assert float((got.scores - want[1]).abs().max()) < 1e-5
    live = got.scores > 0
    assert torch.equal(got.classes[live].long(), want[2][live].long())
    assert float((got.boxes - want[0])[live].abs().max()) < 1e-5
    # The anchor of each detection, as the selection check matches them.
    anchor = want[3][live]
    assert bool((anchor >= 0).all()) and bool((want[3][~live] == -1).all())
    b = torch.arange(2)[:, None].expand_as(live)[live]
    assert float((boxes[b, anchor] - want[0][live]).abs().max()) == 0.0
    assert torch.equal(scores[b, anchor, want[2][live].long()], want[1][live])


def test_kernel_bounds_are_perf_md_s():
    """PERF.md's kernel table: K1 31.1 / 79.6 MB, K2 0.00207 ms, K3 126.5 /
    323.8 and K4 181.2 / 463.9 GFLOP at 320 / 512, B=16."""
    p320, p512 = 6375, 16320
    assert roofline.k1_bytes(16, p320, 31) / 1e6 == pytest.approx(31.1, abs=0.05)
    assert roofline.k1_bytes(16, p512, 31) / 1e6 == pytest.approx(79.6, abs=0.05)
    assert roofline.k2_operations(496, 200) / roofline.PEAK_FLOPS["fp32"] * 1e3 == pytest.approx(
        0.00207, abs=0.00001)
    assert roofline.k3_operations(16, 320, 320) / 1e9 == pytest.approx(126.5, abs=0.05)
    assert roofline.k3_operations(16, 512, 512) / 1e9 == pytest.approx(323.8, abs=0.1)
    assert roofline.k4_operations(16, 160, 160) / 1e9 == pytest.approx(181.2, abs=0.05)
    assert roofline.k4_operations(16, 256, 256) / 1e9 == pytest.approx(463.9, abs=0.1)
    cfg = bench.find_cell("vgg16_vid320.clips16_ahead").config
    b = roofline.bounds_s(cfg, 16)
    assert b["K1"] * 1e3 == pytest.approx(0.00929, abs=0.00001)
    assert b["K3"] * 1e3 == pytest.approx(0.128, abs=0.001)
    # K5 on a 3x3 512->512 conv at 40x40, B=16: operations bound it.
    assert roofline.k5_bound_s(16, 40, 40, 512, 512, 3) == pytest.approx(
        2 * 16 * 1600 * 512 * 9 * 512 / 1979e12)


def formula_bounds_s(cfg, batch):
    """K1-K4's bounds written out from roofline.py's formulas."""
    size, c = int(cfg["size"]), int(cfg["num_classes"])
    p = sum(f * f * (1 + 2 * len(a)) for f, a in zip(cfg["feature_maps"], cfg["aspect_ratios"]))
    k = min(int(cfg["top_k"]), int(cfg["prefilter_anchors"]) or p)
    return {
        "K1": roofline.k1_bytes(batch, p, c) / roofline.PEAK_BYTES,
        "K2": roofline.k2_operations(batch * c, k) / roofline.PEAK_FLOPS["fp32"],
        "K3": roofline.k3_operations(batch, size, size) / roofline.PEAK_FLOPS["bf16"],
        "K4": roofline.k4_operations(batch, size // 2, size // 2) / roofline.PEAK_FLOPS["bf16"],
    }


@pytest.mark.parametrize("config,workload", config_workloads())
def test_kernel_files_give_the_formulas_bounds(config, workload):
    """Exactly, float for float; K5 is named and not counted."""
    cfg = bench.find_cell(workload).config
    assert roofline.bounds_s(cfg, 16) == formula_bounds_s(cfg, 16)
    assert list(roofline.bounds_s(cfg, 16)) == ["K1", "K2", "K3", "K4"]
    assert roofline.kernel_of("void qconv_kernel<128>(Params)") == "K5"


# The most expensive device ops of a traced run of each clip cell, as the
# breakdown names them (trace.short): K6 and cuDNN's convolutions belong to
# no kernel file; K3 and K4 to theirs.
RESNET_TOP_OPS = (
    "void__anonymous_namespace___affine_act_kernel_true__1__uint4___u",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void__anonymous_namespace___affine_act_kernel_true__0__uint4___u",
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc_t",
    "void_at__native___scatter_gather_elementwise_kernel_128__8__at__",
    "void_cutlass__5x_cudnn__Kernel_cutlass_tensorop_bf16_s16816fprop",
    "void_at__native__elementwise_kernel_128__4__at__native__gpu_kern",
    "void_at__native__unrolled_elementwise_kernel_at__native__direct_",
)
VGG_TOP_OPS = {
    "void__anonymous_namespace___conv_stage_kernel___nv_bfloat16__tru": "K4",
    "void__anonymous_namespace___tc__stem_tc_kernel___nv_bfloat16__tr": "K3",
    "void_at__native__vectorized_elementwise_kernel_8__at__native___a": None,
    "void_at__native___anonymous_namespace___max_pool_forward_nhwc_c1": None,
}


def test_trace_names_map_to_their_kernel_files():
    assert {n: roofline.kernel_of(n) for n in RESNET_TOP_OPS} == dict.fromkeys(RESNET_TOP_OPS)
    assert {n: roofline.kernel_of(n) for n in VGG_TOP_OPS} == VGG_TOP_OPS


@pytest.mark.parametrize("config,lo,hi", [("vgg16_vid320", 60e9, 200e9),
                                          ("resnet101_vid512", 60e9, 400e9)])
def test_model_flops(config, lo, hi):
    cell = next(w for w in bench.benchmark()["workloads"] if w["config"] == config)
    flops = roofline.model_flops(bench.find_cell(cell["name"]).config)
    conv4_3 = 2 * 40 * 40 * 512 * 9 * 512  # one conv of VGG-16 at 320, a lower bound's part
    assert lo < flops < hi and flops > conv4_3
    assert np.isfinite(flops)
