"""The port's eval slice against the JAX package: the VOC mAP protocol
(eval/voc_eval.py) on synthetic detections, the batched and streaming
detection runners (eval/runner.py; mirrors tests/test_eval_runner.py), and
bench_torch.py's JSON line at tiny_64 on the CPU. TINY_64, width_mult 0.125,
32 TCB channels, seeded numpy inputs."""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.eval import runner as jrunner
from tdrn_tpu.eval import voc_eval as jvoc
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.inference import make_single_image_forward as j_single
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import eval as teval
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.eval import runner as trunner
from tdrn_tpu_torch.eval import voc_eval as tvoc
from tdrn_tpu_torch.inference import StreamingDetector, make_single_image_forward
from tdrn_tpu_torch.models.detector import build_detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(tcb_channels=32, width_mult=0.125)
AP_ATOL = 1e-12
CLASSES = ("a", "b", "c")

# --- the VOC protocol on synthetic detections --------------------------------


def _synthetic(seed, n_images=6):
    """Ground truth with difficult boxes and an image with none of a class;
    detections that hit, duplicate, miss and land on difficult boxes."""
    rng = np.random.default_rng(seed)
    gt, dets = {}, {ci: {} for ci in range(len(CLASSES))}
    for i in range(n_images):
        n = int(rng.integers(0, 5))
        xy = rng.uniform(0, 200, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (n, 2))], -1).astype(np.float32)
        labels = rng.integers(0, len(CLASSES), n)
        difficult = rng.random(n) < 0.2
        gt[f"img{i}"] = (boxes, labels, difficult)
        for ci in range(len(CLASSES)):
            own = boxes[labels == ci]
            jitter = own + rng.normal(0, 3, own.shape)  # hits, some below IoU 0.5
            dup = own[:1] + rng.normal(0, 1, own[:1].shape)  # a duplicate
            xy = rng.uniform(0, 200, (2, 2))
            miss = np.concatenate([xy, xy + 30], -1)
            b = np.concatenate([jitter, dup, miss]).astype(np.float32)
            dets[ci][f"img{i}"] = (b, rng.random(len(b)).astype(np.float32))
    return gt, dets


def test_eval_package_exports():
    for name in ("voc_ap", "eval_class", "evaluate_detections", "write_voc_results_files"):
        assert getattr(teval, name) is getattr(tvoc, name)


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.default_rng(1)
    for n in (1, 7, 50):
        recall = np.sort(rng.random(n))
        precision = rng.random(n)
        assert abs(tvoc.voc_ap(recall, precision, use_07) - jvoc.voc_ap(recall, precision, use_07)) <= AP_ATOL


@pytest.mark.parametrize("use_07", [True, False])
def test_eval_class_and_evaluate_detections_match_jax(use_07):
    for seed in (0, 1, 2):
        gt, dets = _synthetic(seed)
        for ci in range(len(CLASSES)):
            gt_c = {k: (b[l == ci], d[l == ci]) for k, (b, l, d) in gt.items()}
            t = tvoc.eval_class(gt_c, dets[ci], 0.5, use_07)
            j = jvoc.eval_class(gt_c, dets[ci], 0.5, use_07)
            assert abs(t[0] - j[0]) <= AP_ATOL
            np.testing.assert_allclose(t[1], j[1], atol=AP_ATOL, rtol=0)
            np.testing.assert_allclose(t[2], j[2], atol=AP_ATOL, rtol=0)
        for skip in (False, True):
            t = tvoc.evaluate_detections(gt, dets, CLASSES, 0.5, use_07, skip)
            j = jvoc.evaluate_detections(gt, dets, CLASSES, 0.5, use_07, skip)
            assert t.keys() == j.keys()
            for k in t:
                assert (np.isnan(t[k]) and np.isnan(j[k])) or abs(t[k] - j[k]) <= AP_ATOL, k
            assert 0.0 < t["mAP"] < 1.0


def test_write_voc_results_files_matches_jax(tmp_path):
    _, dets = _synthetic(3)
    tvoc.write_voc_results_files(str(tmp_path / "t"), dets, CLASSES)
    jvoc.write_voc_results_files(str(tmp_path / "j"), dets, CLASSES)
    for c in CLASSES:
        name = f"comp4_det_test_{c}.txt"
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()


# --- the runners ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _params():
    model = j_build(jcfg.TINY_64, temporal=True, **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, None))


def _models():
    jmodel = j_build(jcfg.TINY_64, temporal=True, **SMALL)
    tmodel = build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL)
    return jmodel, weights.load_jax_params(tmodel, _params())


@functools.lru_cache(maxsize=None)
def _snippets():
    """Three snippets of uneven lengths (2, 3, 4 frames)."""
    rng = np.random.RandomState(0)
    return tuple(
        tuple((f"s{s}/f{t}", (64, 64), rng.randint(0, 255, (64, 64, 3), np.uint8))
              for t in range(2 + s))
        for s in range(3)
    )


def _sequential(model, snippets, score_thresh):
    """One lane, one snippet at a time: the trivially correct order."""
    accum = trunner.new_accum()
    det = StreamingDetector(model, num_streams=1, device="cpu")
    for snip in snippets:
        det.reset()
        for img_id, hw, frame in snip:
            out = det.detect(frame[None])
            trunner.record(accum, img_id, hw, out.boxes.numpy()[0], out.scores.numpy()[0],
                           out.classes.numpy()[0], score_thresh)
    return trunner.finalize(accum)


def _assert_same_accum(got, want, score_atol, box_atol):
    assert set(got) == set(want)
    for ci in want:
        assert set(got[ci]) == set(want[ci]), ci
        for img_id in want[ci]:
            gb, gs = got[ci][img_id]
            wb, ws = want[ci][img_id]
            np.testing.assert_allclose(np.sort(gs), np.sort(ws), atol=score_atol)
            np.testing.assert_allclose(gb[np.argsort(gs)], wb[np.argsort(ws)], atol=box_atol)


@pytest.mark.parametrize("lanes", [1, 2])
def test_run_streaming_matches_sequential_and_jax(lanes):
    jmodel, tmodel = _models()
    snippets = _snippets()
    want = _sequential(tmodel, snippets, 0.01)
    det = StreamingDetector(tmodel, num_streams=lanes, device="cpu")
    got = trunner.finalize(trunner.run_streaming(det, snippets, 0.01, progress_every=0))
    _assert_same_accum(got, want, 1e-4, 1e-3)  # tests/test_eval_runner.py
    jdet = JStreamingDetector(jmodel, _params(), num_streams=lanes)
    jgot = jrunner.finalize(jrunner.run_streaming(jdet, snippets, 0.01, progress_every=0))
    _assert_same_accum(got, jgot, 1e-4, 1e-3)


def test_run_batched_matches_jax():
    jmodel, tmodel = _models()
    items = [item for snip in _snippets() for item in snip][:5]  # a ragged last batch
    got = trunner.finalize(trunner.run_batched(
        make_single_image_forward(tmodel), items, 2, 0.01, progress_every=0, device="cpu"))
    want = jrunner.finalize(jrunner.run_batched(
        j_single(jmodel), _params(), items, 2, 0.01, progress_every=0))
    _assert_same_accum(got, want, 1e-4, 1e-3)


# --- bench_torch.py --------------------------------------------------------------


def _bench_fields():
    """The keys of the JSON line bench.py prints, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    block = src[src.index("result = {"):src.index("print(json.dumps(result))")]
    return re.findall(r'^\s*"(\w+)":', block, re.M)


def test_bench_torch_prints_bench_fields():
    fields = _bench_fields()
    assert "metric" in fields and "device" in fields and len(fields) == 15
    out = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu", "--config", "tiny_64",
         "--frames", "2", "--warmup", "1", "--batch", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert set(fields) <= set(row)
    assert row["metric"] == "streaming_tiny_64_frames_per_sec_per_chip"
    assert row["device"] == "cpu" and row["batch"] == 2 and row["prefilter"] == 512
    assert row["value"] > 0 and row["step_ms"] > 0 and row["p50_roundtrip_latency_ms"] > 0


@pytest.mark.parametrize("flags", [["--int8"], ["--int8_tcb"], ["--int8_gru"]])
def test_bench_scripts_refuse_unported_options(flags, capsys):
    """int8 serving is ported: --int8 parses in both scripts, and they refuse
    --int8_tcb or --int8_gru without --int8 (an argparse error naming
    --int8), as bench.py and tools/device_bench.py do."""
    import bench_torch
    from tools import device_bench_torch

    for parse in (bench_torch.parse_args, device_bench_torch.parse_args):
        if flags == ["--int8"]:
            args = parse(flags)
            assert args.int8 and not args.int8_tcb and not args.int8_gru
            assert parse(["--int8", flags[0] + "_tcb", "--int8_gru"]).int8_tcb
            continue
        with pytest.raises(SystemExit):
            parse(flags)
        assert "require --int8" in capsys.readouterr().err
        assert getattr(parse(["--int8"] + flags), flags[0][2:])


@pytest.mark.parametrize("flags", [
    ["--backbone", "resnet101"], ["--cell", "light"], ["--cell", "hybrid"],
    ["--stem", "poly"], ["--stem", "poly2"], ["--stem", "s2d"],
])
def test_bench_scripts_take_ported_options(flags):
    """Both scripts parse each option the port once refused into the same
    model settings, and the model they build (bench_torch.build_model, which
    both call) builds on the CPU at tiny_64, full width, and runs a forward."""
    import bench_torch
    from tools import device_bench_torch

    keys = ("config", "backbone", "stem", "cell", "dtype")
    args, other = (script.parse_args(flags + ["--config", "tiny_64"])
                   for script in (bench_torch, device_bench_torch))
    assert all(getattr(args, k) == getattr(other, k) for k in keys)
    model = bench_torch.build_model(args, "cpu")
    if "--backbone" in flags:
        assert type(model.backbone).__name__ == "ResNetBackbone"
    if "--stem" in flags:
        assert model.backbone.stem == flags[1]
    if "--cell" in flags:
        kinds = {type(m).__name__ for m in model.temporal.children()}
        assert "LightGRUCell" in kinds and (flags[1] == "light") == (len(kinds) == 1)
    with torch.no_grad():
        preds, _ = model(torch.zeros(1, 64, 64, 3))
    assert preds.odm_conf.shape == (1, model.cfg.num_priors, model.cfg.num_classes)


def test_bench_scripts_take_the_selection_options():
    """--approx_topk and --prefilter_recall reach the detect tail's config."""
    import bench_torch
    from tools import device_bench_torch

    for script in (bench_torch, device_bench_torch):
        args = script.parse_args(["--approx_topk", "--prefilter_recall", "0.9", "--prefilter", "64"])
        cfg = bench_torch.selected_config(args)
        assert cfg.approx_topk and cfg.prefilter_recall == 0.9 and cfg.prefilter_anchors == 64
        cfg = bench_torch.selected_config(script.parse_args([]))
        assert not cfg.approx_topk and cfg.prefilter_recall == 1.0
