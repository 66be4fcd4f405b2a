"""The port's host path and CLIs on the CPU, against the JAX package and cv2:
data/image.py against cv2 (resize bit-equal at the downscale shapes and
within 1 level at an upscale; decode against cv2.imread/imdecode); the VOC
and VID readers and the motion breakdown against tdrn_tpu's on a synthetic
tree; serve_torch.py over HTTP on 127.0.0.1:0 against a sequential
detector; test_torch.py's results file and eval_torch.py's mAP (VOC, and VID
--temporal --motion_breakdown) against the JAX forward's detections for the
same frames scored by tdrn_tpu.eval; live_torch.py on a 4-frame MJPG video;
profile_trace_torch.py writing its trace. TINY_64 (and a 31-class TINY_64
named vid_tiny) at width_mult 0.125 with 32 TCB channels, weights a seeded
draw through the port, one JAX compile per forward; and utils/logging.py
against the JAX package's."""

import dataclasses
import http.client
import json
import logging
import os
import re
import sys
import threading

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.data import vid as jvid
from tdrn_tpu.data import voc as jvoc
from tdrn_tpu.eval import evaluate_detections as j_evaluate
from tdrn_tpu.eval import motion as jmotion
from tdrn_tpu.eval import runner as jrunner
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.inference import make_single_image_forward as j_single
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.data import image
from tdrn_tpu_torch.data import vid as tvid
from tdrn_tpu_torch.data import voc as tvoc
from tdrn_tpu_torch.eval import motion as tmotion
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.train import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import eval_torch  # noqa: E402
import live_torch  # noqa: E402
import profile_trace_torch  # noqa: E402
import serve_torch  # noqa: E402
import test_torch  # noqa: E402

log = logging.getLogger(__name__)

SMALL = dict(tcb_channels=32, width_mult=0.125)
SERVE_ATOL = 1e-5  # server against a sequential detector (tests/test_torch_port_serving.py)
# mAP and APs, the port's eval against tdrn_tpu.eval on the JAX forward's
# detections: the detections agree to ~1e-6 (fp32), which moves no rank and
# no IoU past 0.5 here, so the APs agree to float rounding.
AP_ATOL = 1e-6
VID_TINY = "vid_tiny"


# --- data/image.py against cv2 ----------------------------------------------


@pytest.mark.parametrize("hw,size", [((480, 640), 320), ((375, 500), 320), ((481, 641), 320),
                                     ((640, 640), 320), ((100, 37), 64)])
def test_resize_is_bit_equal_to_cv2(hw, size):
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize(img, size), cv2.resize(img, (size, size)))


def test_resize_upscale_and_shapes():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (200, 300, 3), dtype=np.uint8)
    d = np.abs(image.resize(img, 512).astype(int) - cv2.resize(img, (512, 512)))
    log.info("upscale 200x300 -> 512: max |diff| %d, exact share %.5f", d.max(), (d == 0).mean())
    assert d.max() <= 1
    gray = rng.integers(0, 256, (50, 70), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize(gray, (33, 20)), cv2.resize(gray, (33, 20)))
    same = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image.resize(same, 64), same)
    with pytest.raises(ValueError):
        image.resize(img.astype(np.float32), 64)


@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_decode_matches_cv2(tmp_path, ext):
    rng = np.random.default_rng(4)
    bgr = cv2.GaussianBlur(rng.integers(0, 256, (60, 90, 3), dtype=np.uint8), (5, 5), 2)
    path = str(tmp_path / f"a{ext}")
    assert cv2.imwrite(path, bgr)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(image.imread(path), want)
    with open(path, "rb") as f:
        data = f.read()
    dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(image.decode(data), cv2.cvtColor(dec, cv2.COLOR_BGR2RGB))
    # The port's encoder, read back by cv2 (PNG is lossless).
    rgb = want[..., ::-1].copy()
    back = cv2.imdecode(np.frombuffer(image.encode(rgb, ext), np.uint8), cv2.IMREAD_COLOR)
    if ext == ".png":
        np.testing.assert_array_equal(back, rgb[..., ::-1])
    else:
        assert np.abs(back.astype(int) - rgb[..., ::-1]).mean() < 3
    assert image.decode(b"not an image") is None
    with pytest.raises(ValueError):
        image.encode(rgb, ".gif")


# --- a synthetic VOC / VID tree, checkpoints, the JAX forward's detections ---


def _xml_voc(objs):
    body = "".join(
        f"<object><name>{name}</name><difficult>{int(diff)}</difficult><bndbox>"
        f"<xmin>{v[0] + 1!r}</xmin><ymin>{v[1] + 1!r}</ymin><xmax>{v[2] + 1!r}</xmax>"
        f"<ymax>{v[3] + 1!r}</ymax></bndbox></object>"
        for name, b, diff in objs for v in [[float(x) for x in b]])
    return f"<annotation>{body}</annotation>"


def _xml_vid(objs):
    body = "".join(
        f"<object><trackid>{t}</trackid><name>{wnid}</name><bndbox><xmin>{v[0]!r}</xmin>"
        f"<ymin>{v[1]!r}</ymin><xmax>{v[2]!r}</xmax><ymax>{v[3]!r}</ymax></bndbox></object>"
        for wnid, b, t in objs for v in [[float(x) for x in b]])
    return f"<annotation>{body}</annotation>"


def _top(boxes01, scores, classes, hw, n=2):
    """The frame's n best detections in pixels: (class index, box)."""
    h, w = hw
    order = np.argsort(-scores, kind="stable")[:n]
    return [(int(classes[i]) - 1, (boxes01[i] * [w, h, w, h]).astype(np.float64)) for i in order]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """VOC: 6 JPEGs of three sizes with annotations taken from the JAX
    forward's two best detections (one marked difficult) and a 'person' box
    the model does not predict; VID: 2 snippets x 4 frames annotated with the
    JAX streaming detector's best detection (track 0) and a moving box
    (track 1). Port checkpoints of both models."""
    base = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(11)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tcfg.CONFIGS, VID_TINY,
                   dataclasses.replace(tcfg.TINY_64, name=VID_TINY, num_classes=31))
        out = dict(base=base)
        for name, cfg, temporal, seed in (("voc", tcfg.TINY_64, False, 5),
                                          ("vid", tcfg.CONFIGS[VID_TINY], True, 6)):
            model = build_detector(cfg, temporal=temporal, device="cpu", **SMALL)
            weights.load_random_params(model, seed)
            ck = str(base / f"ck_{name}")
            checkpoint.save_params(ck, 1, model.state_dict())
            checkpoint.save_meta(ck, {"dataset": cfg.name, "backbone": "vgg16",
                                      "temporal": temporal, "stem": "conv",
                                      "temporal_cell": "convgru", "tcb_channels": 32,
                                      "width_mult": 0.125})
            jc = dataclasses.replace(jcfg.TINY_64, name=cfg.name, num_classes=cfg.num_classes)
            out[name] = dict(ckpt=ck, jmodel=j_build(jc, temporal=temporal, **SMALL),
                             params=weights.params_to_jax(model.state_dict()))

        # VOC: images first, then annotations from the JAX detections.
        voc = base / "voc" / "VOC2007"
        for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
            (voc / d).mkdir(parents=True)
        ids = [f"{i:06d}" for i in range(6)]
        sizes = [(48, 80), (64, 64), (100, 70)] * 2
        for img_id, hw in zip(ids, sizes):
            bgr = cv2.GaussianBlur(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), (5, 5), 2)
            cv2.imwrite(str(voc / "JPEGImages" / f"{img_id}.jpg"), bgr)
        (voc / "ImageSets/Main/test.txt").write_text("\n".join(ids) + "\n")
        frames = [cv2.resize(cv2.cvtColor(cv2.imread(str(voc / "JPEGImages" / f"{i}.jpg")),
                                          cv2.COLOR_BGR2RGB), (64, 64)) for i in ids]
        v = out["voc"]
        jd = j_single(v["jmodel"])(v["params"], jnp.asarray(np.stack(frames)))
        for b, (img_id, hw) in enumerate(zip(ids, sizes)):
            top = _top(*(np.asarray(x[b]) for x in (jd.boxes, jd.scores, jd.classes)), hw)
            objs = [(jvoc.VOC_CLASSES[c], box, k == 1) for k, (c, box) in enumerate(top)]
            objs.append(("person", np.array([2.0, 3.0, 20.0, 30.0]), False))
            (voc / "Annotations" / f"{img_id}.xml").write_text(_xml_voc(objs))

        # VID: two snippets, streamed by the JAX detector on 2 lanes.
        vid = base / "vid"
        snippets = []
        for s in range(2):
            (vid / "Data/VID/val" / f"snip{s}").mkdir(parents=True)
            (vid / "Annotations/VID/val" / f"snip{s}").mkdir(parents=True)
            snip = []
            for f in range(4):
                bgr = cv2.GaussianBlur(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8),
                                       (5, 5), 2)
                path = str(vid / "Data/VID/val" / f"snip{s}" / f"{f:06d}.JPEG")
                assert cv2.imwrite(path, bgr)
                rgb = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
                snip.append((f"snip{s}/{f:06d}", rgb.shape[:2], cv2.resize(rgb, (64, 64))))
            snippets.append(snip)
        v = out["vid"]
        jdet = JStreamingDetector(v["jmodel"], v["params"], num_streams=2)
        accum = jrunner.run_streaming(jdet, snippets, score_thresh=0.0)
        dets = jrunner.finalize(accum)
        for s, snip in enumerate(snippets):
            for f, (img_id, hw, _) in enumerate(snip):
                best = max(((ci, b, sc) for ci, d in dets.items() if img_id in d
                            for b, sc in zip(*d[img_id])), key=lambda t: t[2])
                moving = np.array([4.0 + 9 * f * s, 4.0, 30.0 + 9 * f * s, 40.0])
                objs = [(jvid.VID_WNID_CLASSES[best[0]][0], best[1].astype(np.float64), 0),
                        (jvid.VID_WNID_CLASSES[3][0], moving, 1)]
                (vid / "Annotations/VID/val" / f"{img_id}.xml").write_text(_xml_vid(objs))
        out["voc_root"], out["vid_root"] = str(base / "voc"), str(vid)
        yield out


def test_readers_match_jax(tree):
    tds = tvoc.VOCDetection(tree["voc_root"], image_sets=(("2007", "test"),), keep_difficult=True)
    jds = jvoc.VOCDetection(tree["voc_root"], image_sets=(("2007", "test"),), keep_difficult=True)
    assert tds.ids == jds.ids and len(tds) == len(jds) == 6
    for i in range(len(jds)):
        assert tds.image_path(i) == jds.image_path(i)
        for t, j in zip(tds.raw_item(i), jds.raw_item(i)):
            np.testing.assert_array_equal(t, j)
    ann = os.path.join(tree["voc_root"], "VOC2007", "Annotations", "000000.xml")
    for keep in (False, True):
        for t, j in zip(tvoc.parse_voc_xml(ann, keep), jvoc.parse_voc_xml(ann, keep)):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
    assert tvoc.VOC_CLASSES == jvoc.VOC_CLASSES
    tv = tvid.VIDDetection(tree["vid_root"], "val")
    jv = jvid.VIDDetection(tree["vid_root"], "val", mode="frame", transform=None)
    assert tv.snippets == jv.snippets and tv.frames == jv.frames and len(tv) == len(jv) == 8
    for rel, stem in jv.frames:
        for t, j in zip(tv._load_frame(rel, stem), jv._load_frame(rel, stem)):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        ann = os.path.join(tree["vid_root"], "Annotations/VID/val", rel, stem + ".xml")
        for t, j in zip(tvid.parse_vid_xml(ann), jvid.parse_vid_xml(ann)):
            np.testing.assert_array_equal(t, j)
    assert tvid.VID_WNID_CLASSES == jvid.VID_WNID_CLASSES and tvid.VID_CLASSES == jvid.VID_CLASSES


def test_motion_matches_jax(tree):
    rng = np.random.default_rng(7)
    frames = []
    for f in range(12):  # three tracks at three speeds, one appearing once
        boxes = np.array([[10 + 0.2 * f, 10, 50 + 0.2 * f, 50], [10 + 4 * f, 60, 40 + 4 * f, 90],
                          [100 + 15 * f, 5, 130 + 15 * f, 35]], np.float32)
        tracks = np.array([0, 1, 2], np.int32)
        if f == 5:
            boxes = np.concatenate([boxes, rng.uniform(0, 50, (1, 4)).astype(np.float32)])
            tracks = np.append(tracks, 7).astype(np.int32)
        frames.append((boxes, tracks))
    for window in (2, 10):
        for t, j in zip(tmotion.motion_categories_for_snippet(frames, window),
                        jmotion.motion_categories_for_snippet(frames, window)):
            np.testing.assert_array_equal(t, j)
    snips = tvid.VIDDetection(tree["vid_root"], "val").snippets
    tc = tmotion.vid_motion_categories(tree["vid_root"], "val", snips)
    jc = jmotion.vid_motion_categories(tree["vid_root"], "val", snips)
    assert tc.keys() == jc.keys() and len(tc) == 8
    assert {c for v in tc.values() for c in v.tolist()} >= {0, 2}  # slow and fast objects
    for k in tc:
        np.testing.assert_array_equal(tc[k], jc[k])
    part = tmotion.vid_motion_categories(tree["vid_root"], "val", snips, frame_ids={"snip1/000002"})
    assert list(part) == ["snip1/000002"]
    gt = {k: (np.zeros((len(v), 4), np.float32), np.zeros(len(v), np.int32),
              np.zeros(len(v), bool)) for k, v in tc.items()}
    for (tn, tv), (jn, jv) in zip(tmotion.motion_gt_views(gt, tc), jmotion.motion_gt_views(gt, jc)):
        assert tn == jn
        for k in jv:
            np.testing.assert_array_equal(tv[k][2], jv[k][2])


# --- the CLIs ---------------------------------------------------------------


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _start(argv):
    args = serve_torch.parse_args(argv)
    server, names = serve_torch.build_server(args)
    httpd = serve_torch.make_httpd(args, server, names)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return server, names, httpd, thread


def _stop(server, httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    server.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_over_http_matches_a_sequential_detector(tree):
    """Threaded: 3 streams x 3 PNG frames of 48x80 from concurrent clients,
    stream s1 reset before its frame 2, each stream's detections against the
    same decoded and resized frames through a second detector with only that
    lane active; then sync mode, /healthz, a bad image and a bad path."""
    ck = tree["vid"]["ckpt"]
    frames = np.random.default_rng(12).integers(0, 256, (3, 3, 48, 80, 3), dtype=np.uint8)
    server, names, httpd, thread = _start(
        ["--checkpoint", ck, "--port", "0", "--lanes", "3", "--mode", "threaded",
         "--device", "cpu", "--window_ms", "1"])
    port = httpd.server_address[1]
    results, errors = {s: [] for s in range(3)}, []

    def client(s):
        try:
            for i in range(3):
                if (s, i) == (1, 2):
                    assert _post(port, f"/reset?stream=s{s}", b"") == (200, {"ok": True})
                status, body = _post(port, f"/detect?stream=s{s}&thresh=0",
                                     image.encode(frames[i, s], ".png"))
                assert status == 200 and body["stream"] == f"s{s}"
                results[s].append(body["detections"])
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(not t.is_alive() for t in threads)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        assert health["ok"] and health["frames"] == 9 and health["latency"]["n"] == 9
        assert _post(port, "/detect?stream=x", b"garbage")[0] == 400
        assert _post(port, "/nowhere", b"")[0] == 404
        lanes = {s: server._lane_of[f"s{s}"] for s in range(3)}
    finally:
        _stop(server, httpd, thread)

    ref = StreamingDetector(server.det.model, num_streams=3, device="cpu")
    worst = 0.0
    for s in range(3):
        ref.reset()
        buf = np.zeros((3, 64, 64, 3), np.uint8)
        active = np.zeros(3, np.float32)
        active[lanes[s]] = 1.0
        for i in range(3):
            if (s, i) == (1, 2):
                ref.reset([lanes[s]])
            buf[lanes[s]] = image.resize(frames[i, s], 64)
            out = ref.detect(buf, active=active)
            b, sc, c = (t[lanes[s]].numpy() for t in (out.boxes, out.scores, out.classes))
            got = results[s][i]
            assert len(got) == len(sc)
            assert [d["class"] for d in got] == [names[int(k) - 1] for k in c]
            worst = max(worst, np.abs(np.array([d["score"] for d in got]) - sc).max(),
                        np.abs(np.array([d["box"] for d in got]) - b * [80, 48, 80, 48]).max())
    log.info("serve_torch over HTTP against a sequential detector: max|diff| %.3g", worst)
    assert worst <= SERVE_ATOL

    # Sync mode: detect inline on the HTTP thread.
    server, names, httpd, thread = _start(["--checkpoint", ck, "--port", "0", "--lanes", "2",
                                           "--device", "cpu"])
    try:
        port = httpd.server_address[1]
        status, body = _post(port, "/detect?stream=a&thresh=0.0",
                             image.encode(frames[0, 0], ".jpg"))
        assert status == 200 and len(body["detections"]) == 200
        assert server.steps == server.frames == 1
    finally:
        _stop(server, httpd, thread)


_LINE = re.compile(r"PREDICTION: label: (\w+) score: ([\d.]+) box: ([-\d. ]+)")


def test_test_torch_writes_the_reference_results_file(tree, tmp_path):
    out = str(tmp_path / "res" / "test1.txt")
    thresh = 0.3
    test_torch.main(["--data_root", tree["voc_root"], "--checkpoint", tree["voc"]["ckpt"],
                     "--out_file", out, "--visual_thresh", str(thresh), "--batch_size", "4",
                     "--device", "cpu"])
    blocks = open(out).read().split("GROUND TRUTH FOR: ")[1:]
    ds = jvoc.VOCDetection(tree["voc_root"], image_sets=(("2007", "test"),))
    assert [b.split("\n")[0] for b in blocks] == [i for _, i in ds.ids]
    # The same file from the JAX forward on cv2-read and cv2-resized frames.
    v = tree["voc"]
    imgs = [cv2.cvtColor(cv2.imread(ds.image_path(i)), cv2.COLOR_BGR2RGB) for i in range(len(ds))]
    jd = j_single(v["jmodel"])(v["params"], jnp.asarray(np.stack(
        [cv2.resize(im, (64, 64)) for im in imgs])))
    n_lines = 0
    for b, (block, img) in enumerate(zip(blocks, imgs)):
        h, w = img.shape[:2]
        scores = np.asarray(jd.scores[b])
        keep = scores >= thresh
        want = [(tvoc.VOC_CLASSES[int(c) - 1], s, bx * [w, h, w, h]) for bx, s, c in zip(
            np.asarray(jd.boxes[b])[keep], scores[keep], np.asarray(jd.classes[b])[keep])]
        got = _LINE.findall(block)
        assert len(got) == len(want) == block.count("PREDICTION:")
        for (label, s, box), (wl, ws, wb) in zip(got, want):
            assert label == wl and abs(float(s) - ws) <= 1e-4
            np.testing.assert_allclose([float(x) for x in box.split()], wb, atol=0.051)
        n_lines += len(got)
    assert n_lines > 0


def test_eval_torch_voc_map_matches_jax(tree):
    aps, _ = eval_torch.main(["--data_root", tree["voc_root"], "--checkpoint",
                              tree["voc"]["ckpt"], "--batch_size", "4", "--device", "cpu"])
    ds = jvoc.VOCDetection(tree["voc_root"], image_sets=(("2007", "test"),), keep_difficult=True)
    items, gt = [], {}
    for i in range(len(ds)):
        img, boxes, labels, difficult, img_id = ds.raw_item(i)
        gt[img_id] = (boxes, labels, difficult)
        items.append((img_id, img.shape[:2], cv2.resize(img, (64, 64))))
    v = tree["voc"]
    dets = jrunner.finalize(jrunner.run_batched(j_single(v["jmodel"]), v["params"], items, 4))
    want = j_evaluate(gt, dets, jvoc.VOC_CLASSES)
    log.info("eval_torch VOC mAP %.6f, JAX %.6f", aps["mAP"], want["mAP"])
    # Annotations from the JAX detections: real scores on the classes the
    # 4-class model predicts (mAP averages all 20).
    assert want["mAP"] > 0 and max(v for k, v in want.items() if k != "mAP") > 0.3
    for k, v in want.items():
        assert abs(aps[k] - v) <= AP_ATOL or (np.isnan(v) and np.isnan(aps[k])), k


def test_eval_torch_vid_temporal_map_matches_jax(tree):
    aps, _ = eval_torch.main(["--data_root", tree["vid_root"], "--checkpoint",
                              tree["vid"]["ckpt"], "--temporal", "--motion_breakdown",
                              "--batch_size", "2", "--score_thresh", "0.0", "--device", "cpu"])
    jv = jvid.VIDDetection(tree["vid_root"], "val", mode="frame", transform=None)
    snippets, gt = [], {}
    for rel, stems in jv.snippets:
        snip = []
        for stem in stems:
            img, boxes, labels = jv._load_frame(rel, stem)
            gt[f"{rel}/{stem}"] = (boxes, labels, np.zeros(len(labels), bool))
            snip.append((f"{rel}/{stem}", img.shape[:2], cv2.resize(img, (64, 64))))
        snippets.append(snip)
    v = tree["vid"]
    jdet = JStreamingDetector(v["jmodel"], v["params"], num_streams=2)
    dets = jrunner.finalize(jrunner.run_streaming(jdet, snippets, 0.0))
    want = j_evaluate(gt, dets, jvid.VID_CLASSES)
    cats = jmotion.vid_motion_categories(tree["vid_root"], "val", jv.snippets)
    for cname, view in jmotion.motion_gt_views(gt, cats):
        want[f"mAP({cname})"] = j_evaluate(view, dets, jvid.VID_CLASSES,
                                           skip_empty_classes=True)["mAP"]
    log.info("eval_torch VID temporal %s, JAX %s",
             {k: v for k, v in aps.items() if k.startswith("mAP")},
             {k: v for k, v in want.items() if k.startswith("mAP")})
    assert want["mAP"] > 0 and "mAP(fast)" in aps
    for k, v in want.items():
        assert abs(aps[k] - v) <= AP_ATOL or (np.isnan(v) and np.isnan(aps[k])), k


def test_eval_torch_refuses_bad_int8_flags(tree):
    base = ["--data_root", tree["voc_root"], "--checkpoint", tree["voc"]["ckpt"],
            "--precision", "int8", "--device", "cpu", "--max_images", "2"]
    with pytest.raises(SystemExit, match="calib_percentile"):
        eval_torch.main(base + ["--calib_percentile", "0.999"])
    with pytest.raises(SystemExit, match="needs --temporal"):
        eval_torch.main(base + ["--int8_gru"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_torch.main(["--data_root", tree["voc_root"], "--checkpoint",
                         str(tree["base"] / "empty"), "--device", "cpu"])


def test_live_torch_on_a_video(tree, tmp_path):
    src = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (80, 48))
    assert writer.isOpened()
    rng = np.random.default_rng(13)
    for _ in range(4):
        writer.write(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8))
    writer.release()
    out = str(tmp_path / "out.mp4")
    n = live_torch.main(["--checkpoint", tree["vid"]["ckpt"], "--source", src, "--out", out,
                         "--score_thresh", "0.0", "--device", "cpu", "--precision", "bf16"])
    assert n == 4 and os.path.getsize(out) > 0
    assert live_torch.main(["--checkpoint", tree["vid"]["ckpt"], "--source", src,
                            "--max_frames", "2", "--pad_stem", "8", "--device", "cpu"]) == 2
    with pytest.raises(SystemExit, match="cannot open"):
        live_torch.main(["--checkpoint", tree["vid"]["ckpt"], "--source",
                         str(tmp_path / "none.avi"), "--device", "cpu"])


def test_profile_trace_torch_writes_its_trace(tmp_path):
    out = str(tmp_path / "trace")
    times = profile_trace_torch.main(["--config", "tiny_64", "--batch", "2", "--frames", "2",
                                      "--out", out, "--device", "cpu"])
    assert set(times) == {"first_step", "warm_steps", "traced_steps"}
    with open(os.path.join(out, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert "Self CPU" in open(os.path.join(out, "kernels.txt")).read()
    with pytest.raises(SystemExit):
        profile_trace_torch.parse_args(["--int8_tcb"])


def test_logging_matches_jax(tmp_path, capsys):
    """MetricsLogger writes the JAX package's JSONL records and echo lines,
    with TensorBoard scalars through torch.utils.tensorboard; Timer sums
    stages and fences on a tensor or a device."""
    from tdrn_tpu.utils import logging as jlog
    from tdrn_tpu_torch.utils import logging as tlog

    lines = {}
    for name, mod in (("t", tlog), ("j", jlog)):
        logger = mod.MetricsLogger(str(tmp_path / name), echo_every=2)
        for step in range(4):
            logger.log(step, {"loss": 1.5 / (step + 1), "lr": np.float32(0.01)})
        logger.close()
        with open(os.path.join(str(tmp_path / name), "metrics.jsonl")) as f:
            lines[name] = [{k: v for k, v in json.loads(x).items() if k != "time"} for x in f]
        lines[name + "_echo"] = capsys.readouterr().out
    assert lines["t"] == lines["j"] and len(lines["t"]) == 4
    assert lines["t_echo"] == lines["j_echo"] == (
        "[step 0] loss=1.5000 lr=0.0100\n[step 2] loss=0.5000 lr=0.0100\n")
    tb = tlog.MetricsLogger(str(tmp_path / "tb"), tensorboard=True, echo_every=0)
    tb.log(1, {"loss": 2.0})
    tb.close()
    assert os.listdir(str(tmp_path / "tb" / "tb"))
    timer = tlog.Timer()
    for fence in (None, torch.ones(2), "cpu"):
        with timer.time("stage", fence=fence):
            sum(range(1000))
    assert set(timer.times) == {"stage"} and timer.times["stage"] > 0
    with tlog.profile_trace(None) as prof:
        assert prof is None
