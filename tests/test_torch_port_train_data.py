"""The port's training input pipeline, weights, checkpoints and CLIs:

  * SSDAugmentation (sample_params / apply), BaseTransform, VOC and VID
    samples (frame and clip mode, the masked tail of a short snippet),
    collate_batch / collate_clips and the loader's batch stream for a seed:
    bit-equal to the JAX package's on a seeded mini VOC and mini VID written
    to tmp_path;
  * the VGG-16 .pth layouts (reduced-fc and torchvision) on synthetic state
    dicts, against the JAX package's load_vgg_backbone;
  * train-state checkpoints (port only): N steps straight equal k steps, a
    save, a restore and N-k more, bit for bit on the CPU; max_to_keep;
  * train_torch.py --device cpu on the mini VOC (with --pretrained and
    --qat) and the mini VID (--clip with --init_from, --bf16 --remat and
    --mixed_frames) at TINY_64 with width_mult 0.125 and 32 TCB channels: 2
    steps, a save, a resume ("resumed at step 2"), and the checkpoint read by
    load_inference_model; its refusals;
  * tools/train_bench_torch.py --device cpu, with --profile.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tdrn_tpu.data import augment as jaug
from tdrn_tpu.data import loader as jloader
from tdrn_tpu.data import vid as jvid
from tdrn_tpu.data import voc as jvoc
from tdrn_tpu.utils import torch_weights as jtw
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.data import augment as taug
from tdrn_tpu_torch.data import image
from tdrn_tpu_torch.data import loader as tloader
from tdrn_tpu_torch.data import vid as tvid
from tdrn_tpu_torch.data import voc as tvoc
from tdrn_tpu_torch.inference import load_inference_model
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.train import Targets, init_train_state, make_optimizer, make_train_step
from tdrn_tpu_torch.train.checkpoint import CheckpointManager
from tdrn_tpu_torch.utils import quantize as tq
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import train_bench_torch  # noqa: E402

sys.path.insert(0, ROOT)
import train_torch  # noqa: E402

SMALL = dict(width_mult=0.125, tcb_channels=32)
SIZE = 64
# 21- and 31-class TINY_64 geometries for the CLI runs on VOC and VID labels.
TINY_CFGS = {"voc_tiny": 21, "vid_tiny": 31}


def _write_voc(root, rng, n=5):
    base = os.path.join(root, "VOC2007")
    for d in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    ids = [f"{i:06d}" for i in range(n)]
    for i, img_id in enumerate(ids):
        h, w = (60, 80) if i % 2 else (75, 100)
        image.imwrite(os.path.join(base, "JPEGImages", img_id + ".jpg"),
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        objs = ""
        for _ in range(int(rng.integers(1, 4))):
            x, y = int(rng.integers(1, w // 2)), int(rng.integers(1, h // 2))
            objs += (f"<object><name>{tvoc.VOC_CLASSES[int(rng.integers(0, 20))]}</name>"
                     f"<difficult>0</difficult><bndbox><xmin>{x}</xmin><ymin>{y}</ymin>"
                     f"<xmax>{x + w // 3}</xmax><ymax>{y + h // 3}</ymax></bndbox></object>")
        with open(os.path.join(base, "Annotations", img_id + ".xml"), "w") as f:
            f.write(f"<annotation>{objs}</annotation>")
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def _write_vid(root, rng, lengths=(4, 4, 2)):
    """Snippets of 48x64 frames, one moving object each; the short last
    snippet gives clips a masked tail; frame 1 of snippet 0 has no
    annotation file."""
    for s, n in enumerate(lengths):
        data = os.path.join(root, "Data", "VID", "train", f"snip{s}")
        ann = os.path.join(root, "Annotations", "VID", "train", f"snip{s}")
        os.makedirs(data, exist_ok=True)
        os.makedirs(ann, exist_ok=True)
        for f in range(n):
            image.imwrite(os.path.join(data, f"{f:06d}.JPEG"),
                          rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
            if s == 0 and f == 1:
                continue
            x = 4 + 6 * f
            with open(os.path.join(ann, f"{f:06d}.xml"), "w") as fh:
                fh.write(f"<annotation><object><trackid>0</trackid>"
                         f"<name>{tvid.VID_WNID_CLASSES[s][0]}</name><bndbox><xmin>{x}</xmin>"
                         f"<ymin>6</ymin><xmax>{x + 30}</xmax><ymax>40</ymax></bndbox>"
                         f"</object></annotation>")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_data")
    rng = np.random.default_rng(21)
    _write_voc(str(base / "voc"), rng)
    _write_vid(str(base / "vid"), rng)
    return dict(base=base, voc=str(base / "voc"), vid=str(base / "vid"))


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


def _augs(photometric=True, seed=4):
    return (jaug.SSDAugmentation(SIZE, seed=seed, photometric=photometric),
            taug.SSDAugmentation(SIZE, seed=seed, photometric=photometric))


def test_augment_bit_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (75, 100, 3), dtype=np.uint8)
    boxes = np.asarray([[5, 6, 40, 50], [30, 20, 90, 70], [60, 5, 70, 12]], np.float32)
    labels = np.asarray([3, 7, 11], np.int32)
    for photometric in (True, False):
        ja, ta = _augs(photometric)
        for seed in range(12):
            pj = ja.sample_params(img.shape, boxes, np.random.default_rng(seed))
            pt = ta.sample_params(img.shape, boxes, np.random.default_rng(seed))
            photo = lambda p: None if p.photo is None else dataclasses.astuple(p.photo)
            assert (photo(pj) == photo(pt) and pj.expand == pt.expand and pj.mirror == pt.mirror
                    and np.array_equal(pj.crop_rect, pt.crop_rect))
            _equal(ja(img, boxes, labels, rng=np.random.default_rng(seed)),
                   ta(img, boxes, labels, rng=np.random.default_rng(seed)))
    _equal([jaug.BaseTransform(SIZE)(img)], [taug.BaseTransform(SIZE)(img)])


def test_voc_samples_and_collate(data):
    ja, ta = _augs()
    sets = (("2007", "trainval"),)
    jd = jvoc.VOCDetection(data["voc"], image_sets=sets, transform=ja, seed=3)
    td = tvoc.VOCDetection(data["voc"], image_sets=sets, transform=ta, seed=3)
    assert len(jd) == len(td) == 5
    for salt in (0, 1):
        js = [jd.sample(i, salt) for i in range(len(jd))]
        ts = [td.sample(i, salt) for i in range(len(td))]
        for a, b in zip(js, ts):
            _equal(a, b)
        _equal(jvoc.collate_batch(js), tvoc.collate_batch(ts))
    # No transform: the raw image and its boxes over the image size.
    _equal(jvoc.VOCDetection(data["voc"], image_sets=sets)[2],
           tvoc.VOCDetection(data["voc"], image_sets=sets)[2])


def test_vid_frame_and_clip_samples(data):
    ja, ta = _augs()
    jf = jvid.VIDDetection(data["vid"], "train", mode="frame", transform=ja, seed=5)
    tf = tvid.VIDDetection(data["vid"], "train", mode="frame", transform=ta, seed=5)
    assert len(jf) == len(tf) == 10
    for i in range(len(jf)):
        _equal(jf.sample(i, 2), tf.sample(i, 2))
    jc = jvid.VIDDetection(data["vid"], "train", mode="clip", seq_len=3, transform=ja, seed=5)
    tc = tvid.VIDDetection(data["vid"], "train", mode="clip", seq_len=3, transform=ta, seed=5)
    assert len(jc) == len(tc) == 3
    js = [jc.sample(i, 1) for i in range(3)]
    ts = [tc.sample(i, 1) for i in range(3)]
    for a, b in zip(js, ts):
        _equal(a, b)
    assert not ts[2][3][2:].any() and ts[2][3][:2].any()  # the short snippet's masked tail
    _equal(jvid.collate_clips(js), tvid.collate_clips(ts))
    assert tvid.collate_clips(ts)[0].shape == (3, 3, SIZE, SIZE, 3)
    with pytest.raises(ValueError):
        tvid.VIDDetection(data["vid"], "train", mode="snippet")


@pytest.mark.parametrize("clip", [False, True])
def test_loader_stream_matches_jax(data, clip):
    ja, ta = _augs()
    if clip:
        jd = jvid.VIDDetection(data["vid"], "train", mode="clip", seq_len=2, transform=ja, seed=1)
        td = tvid.VIDDetection(data["vid"], "train", mode="clip", seq_len=2, transform=ta, seed=1)
    else:
        sets = (("2007", "trainval"),)
        jd = jvoc.VOCDetection(data["voc"], image_sets=sets, transform=ja, seed=1)
        td = tvoc.VOCDetection(data["voc"], image_sets=sets, transform=ta, seed=1)
    jl = jloader.make_loader(jd, batch_size=2, num_workers=2, clip_mode=clip, seed=9)
    tl = tloader.make_loader(td, batch_size=2, num_workers=3, clip_mode=clip, seed=9)
    try:
        for _ in range(4):  # past an epoch: the epoch salts the augmentation
            jb, tb = next(jl), next(tl)
            assert all(isinstance(t, torch.Tensor) for t in tb)
            _equal(jb, [t.numpy() for t in tb])
    finally:
        jl.close()
        tl.close()


def _reducedfc_sd(model, torchvision=False):
    """A synthetic VGG-16 state dict in either layout, shaped for the
    model's backbone (conv6/conv7 left out of the torchvision one)."""
    rng = np.random.default_rng(12)
    sd = {}
    for idx, name in weights._REDUCEDFC_MAP.items():
        if torchvision and idx >= 31:
            continue
        conv = getattr(model.backbone, name)
        prefix = f"features.{idx}" if torchvision else str(idx)
        sd[f"{prefix}.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, tuple(conv.weight.shape)).astype(np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, tuple(conv.bias.shape)).astype(np.float32))
    if torchvision:
        sd["classifier.0.weight"] = torch.zeros(4, 4)  # fc layers: ignored
    return sd


@pytest.mark.parametrize("torchvision", [False, True])
def test_vgg_pth_layout_matches_jax(tmp_path, torchvision):
    model = build_detector(tcfg.TINY_64, temporal=False, device="cpu", **SMALL)
    weights.load_random_params(model, 1)
    sd = _reducedfc_sd(model, torchvision)
    path = str(tmp_path / "vgg.pth")
    torch.save(sd, path)
    jparams = weights.params_to_jax(model.state_dict())
    jnew, jloaded, jskipped = jtw.load_vgg_backbone(jparams, path)
    _, loaded, skipped = weights.load_vgg_backbone(model, path)
    assert (loaded, skipped) == (jloaded, jskipped)
    assert len(loaded) == (13 if torchvision else 15)
    want = weights.params_from_jax(jnew)
    got = model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # A shape mismatch is skipped, or raises under strict.
    bad = dict(sd)
    key = "features.0.weight" if torchvision else "0.weight"
    bad[key] = torch.zeros(3, 3, 3, 3)
    _, _, skipped = weights.load_vgg_backbone(model, bad)
    assert "conv1_1" in skipped
    with pytest.raises(ValueError):
        weights.load_vgg_backbone(model, bad, strict=True)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0, 0.6, (2, 4, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.4, (2, 4, 2))], -1)
        out.append((torch.from_numpy(rng.uniform(-100, 100, (2, SIZE, SIZE, 3)).astype(np.float32)),
                    Targets(torch.from_numpy(boxes.astype(np.float32)),
                            torch.from_numpy(rng.integers(0, 3, (2, 4)).astype(np.int32)),
                            torch.from_numpy(rng.random((2, 4)) < 0.8))))
    return out


def test_exact_resume_and_max_to_keep(tmp_path):
    model = build_detector(tcfg.TINY_64, temporal=False, device="cpu", **SMALL)
    weights.load_random_params(model, 2)
    opt = make_optimizer(base_lr=1e-2, warmup_steps=2)
    step = make_train_step(model, opt)
    batches = _batches(4)
    straight = init_train_state(model, opt)
    for x, t in batches:
        straight, _ = step(straight, x, t)
    mgr = CheckpointManager(str(tmp_path / "ck"), save_every=1, max_to_keep=2)
    ts = init_train_state(model, opt)
    for x, t in batches[:2]:
        ts, _ = step(ts, x, t)
        assert mgr.maybe_save(ts)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ck")) == ["1", "2"]
    template = init_train_state(model, opt)
    resumed = CheckpointManager(str(tmp_path / "ck")).restore_latest(template)
    assert resumed.step == 2 and resumed.opt_state.count == 2
    assert all(torch.equal(resumed.params[k], ts.params[k]) for k in ts.params)
    assert all(torch.equal(resumed.opt_state.trace[k], ts.opt_state.trace[k]) for k in ts.params)
    for x, t in batches[2:]:
        resumed, _ = step(resumed, x, t)
    assert resumed.step == straight.step == 4
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
        assert torch.equal(resumed.opt_state.trace[k], straight.opt_state.trace[k]), k
    for more in (3, 4):
        resumed = resumed._replace(step=more)
        mgr.maybe_save(resumed)
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    assert not mgr.maybe_save(resumed._replace(step=0))
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(template) is None


def _train(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ts, logged = train_torch.main(argv + ["--device", "cpu", "--width_mult", "0.125",
                                              "--tcb_channels", "32", "--num_workers", "2",
                                              "--warmup", "1", "--log_every", "1"])
    return ts, logged, out.getvalue()


@pytest.fixture(scope="module")
def tiny_cfgs():
    with pytest.MonkeyPatch.context() as mp:
        for name, n in TINY_CFGS.items():
            mp.setitem(tcfg.CONFIGS, name,
                       dataclasses.replace(tcfg.TINY_64, name=name, num_classes=n))
        yield


def test_train_torch_voc(data, tiny_cfgs, tmp_path):
    """Frame mode on the mini VOC from a synthetic reduced-fc .pth, with QAT
    on scales calibrated by the port: 2 steps, then a resume to 3."""
    model = build_detector(tcfg.CONFIGS["voc_tiny"], temporal=False, device="cpu", **SMALL)
    pth = str(tmp_path / "vgg.pth")
    torch.save(_reducedfc_sd(model), pth)
    frames = np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    scales_path = str(tmp_path / "scales.json")
    tq.save_act_scales(scales_path, tq.calibrate_act_scales(
        model, preprocess_batch(torch.from_numpy(frames), tcfg.TINY_64)))
    ck = str(tmp_path / "voc_ck")
    argv = ["--dataset", "voc_tiny", "--data_root", data["voc"], "--image_sets",
            "2007:trainval", "--batch_size", "2", "--save_folder", ck, "--save_every", "2",
            "--pretrained", pth, "--qat", "--int8_scales", scales_path]
    ts, logged, out = _train(argv + ["--max_iter", "2"])
    assert "pretrained: grafted 15 tensors" in out and "qat: fake-quantizing 17 convs" in out
    assert ts.step == 2 and np.isfinite(logged["loss"])
    assert sorted(d for d in os.listdir(ck) if d.isdigit()) == ["2"]
    ts, logged, out = _train(argv + ["--max_iter", "3", "--resume"])
    assert "resumed at step 2" in out and ts.step == 3
    meta = json.load(open(os.path.join(ck, "model_meta.json")))
    assert meta["qat"] and not meta["temporal"] and meta["tcb_channels"] == 32
    loaded = load_inference_model(ck, device="cpu", verbose=False)
    assert loaded.step == 3 and loaded.cfg.name == "voc_tiny"
    sd = loaded.model.state_dict()
    assert all(torch.equal(sd[k], ts.params[k]) for k in ts.params)
    int8 = load_inference_model(ck, precision="int8", int8_scales=scales_path, device="cpu",
                                verbose=False)
    assert int8.model.quant


def test_train_torch_vid_clip(data, tiny_cfgs, tmp_path):
    """Clip mode on the mini VID, initialized from a frame-trained run (the
    temporal subtree fresh), bf16 with remat and one mixed frame step an
    iteration: 2 steps, then a resume to 3."""
    frame_ck = str(tmp_path / "frame_ck")
    _train(["--dataset", "vid_tiny", "--data_root", data["vid"], "--batch_size", "2",
            "--save_folder", frame_ck, "--max_iter", "1"])
    ck = str(tmp_path / "vid_ck")
    argv = ["--dataset", "vid_tiny", "--data_root", data["vid"], "--clip", "--seq_len", "2",
            "--batch_size", "2", "--save_folder", ck, "--save_every", "2", "--bf16", "--remat",
            "--mixed_frames", "2", "--init_from", frame_ck]
    ts, logged, out = _train(argv + ["--max_iter", "2"])
    assert "init_from" in out and "fresh subtree(s) ['temporal']" in out
    assert ts.step == 2 and np.isfinite(logged["loss"]) and np.isfinite(logged["frame_loss"])
    ts, _, out = _train(argv + ["--max_iter", "3", "--resume"])
    assert "resumed at step 2" in out and ts.step == 3
    loaded = load_inference_model(ck, device="cpu", verbose=False)
    assert loaded.step == 3 and loaded.model.temporal_enabled
    sd = loaded.model.state_dict()
    assert all(torch.equal(sd[k], ts.params[k]) for k in ts.params)


def test_train_torch_refusals(data, tiny_cfgs, tmp_path):
    base = ["--data_root", data["voc"], "--save_folder", str(tmp_path / "x")]
    for extra in (["--dataset", "tiny_64"],  # 4 classes for VOC's 20
                  ["--dataset", "voc_tiny", "--qat"],
                  ["--dataset", "voc_tiny", "--mixed_frames", "2"]):
        with pytest.raises(SystemExit):
            _train(base + extra + ["--image_sets", "2007:trainval", "--max_iter", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_torch.main(base + ["--dataset", "voc_tiny"])


def test_train_bench_torch_cpu(tmp_path):
    prof = str(tmp_path / "profile.txt")
    out = train_bench_torch.main(["--device", "cpu", "--config", "tiny_64", "--clip",
                                  "--seq_len", "2", "--batch", "2", "--steps", "1",
                                  "--warmup", "1", "--bf16", "--remat", "--width_mult",
                                  "0.125", "--tcb_channels", "32", "--profile", prof])
    assert out["device"] == "cpu" and out["ms_per_step"] > 0 and np.isfinite(out["loss"])
    assert out["value"] == pytest.approx(4 / out["ms_per_step"] * 1e3)
    parts = out["profile_ms_a_step"]
    assert {"tdrn::forward", "tdrn::loss", "tdrn::match", "tdrn::mine", "tdrn::backward",
            "tdrn::optimizer", "device_busy", "kernels_by_kind", "idle_share"} <= parts.keys()
    assert os.path.getsize(prof) > 0
    frame = train_bench_torch.main(["--device", "cpu", "--config", "tiny_64", "--batch", "2",
                                    "--steps", "1", "--warmup", "1", "--width_mult", "0.125",
                                    "--tcb_channels", "32"])
    assert not frame["clip"] and frame["peak_memory_gib"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_bench_torch.main(["--config", "tiny_64"])
