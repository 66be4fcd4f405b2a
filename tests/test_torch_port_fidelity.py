"""The port's fidelity tools and the new train_torch.py flags, on the CPU at a
small size (TINY widths: width_mult 0.125, 32 TCB channels; 2 steps):

  * tools/synth_fidelity_torch.py (easy profile, --prefilter_check) and
    tools/synth_vid_fidelity_torch.py (staged) with --device cpu, each ending
    in its JSON line with an AP for every class of its task;
  * tools/verify_pretrained_torch.py on a synthetic vgg16_reducedfc-layout
    state dict: the port's graft and the JAX package's agree within 1e-4,
    and a kernel the port's converter transposes (mutated here) fails;
  * train_torch.py --loader processes --tensorboard on a mini VOC: its
    TensorBoard event file, and the first step's loss equal to --loader
    threads' (the same batch); train.py's --loader grain accepted.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.models.detector import build_detector
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_port_train_data import _reducedfc_sd, _write_voc, tiny_cfgs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import synth_fidelity_torch  # noqa: E402
import synth_vid_fidelity_torch  # noqa: E402
import verify_pretrained_torch  # noqa: E402

sys.path.insert(0, ROOT)
import train_torch  # noqa: E402

SMALL_TRAIN = "--width_mult 0.125 --tcb_channels 32 --num_workers 2"


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_synth_fidelity_torch_cpu(tmp_path, capsys):
    record = str(tmp_path / "fidelity.json")
    res = synth_fidelity_torch.main([
        "--device", "cpu", "--out", str(tmp_path / "easy"), "--steps", "2", "--n_train", "4",
        "--batch_size", "2", "--prefilter_check", "--record", record,
        "--extra_train_args", SMALL_TRAIN + " --log_every 1"])
    assert _last_json(capsys) == res == json.load(open(record))
    assert sorted(res["per_class"]) == sorted(synth_fidelity_torch.CLASSES)
    assert all(0.0 <= v <= 1.0 for v in res["per_class"].values())
    assert res["mAP"] == pytest.approx(np.mean(list(res["per_class"].values())))
    assert res["card"] == "cpu" and res["loader"] == "processes" and res["threshold"] == 0.9
    assert res["pass"] == (res["mAP"] >= 0.9) and res["prefilter_delta"] is not None
    first, last = res["train_loss_first_last"]
    assert np.isfinite(first) and np.isfinite(last)
    assert len(res["eval_s"]) == 2  # exact and --prefilter 512


def test_synth_vid_fidelity_torch_cpu(tmp_path, capsys):
    res = synth_vid_fidelity_torch.main([
        "--device", "cpu", "--out", str(tmp_path / "vid"), "--steps", "2", "--n_train", "3",
        "--n_val", "2", "--frames", "6", "--seq_len", "2", "--batch_size", "2",
        "--frame_batch_size", "2", "--extra_train_args", SMALL_TRAIN])
    assert _last_json(capsys) == res
    classes = sorted(synth_vid_fidelity_torch.CLASSES)
    assert sorted(res["temporal_per_class"]) == sorted(res["frame_per_class"]) == classes
    assert res["temporal_advantage"] == round(res["temporal_mAP"] - res["frame_mAP"], 4)
    assert res["pass"] == (res["temporal_advantage"] > 0) and res["staged"]
    assert set(res["temporal_motion_mAP"]) <= {"slow", "medium", "fast"}
    assert res["card"] == "cpu" and len(res["eval_s"]) == 2


@pytest.mark.parametrize("mutate", [False, True], ids=["faithful", "mis-transposed"])
def test_verify_pretrained_torch(tmp_path, monkeypatch, capsys, mutate):
    model = build_detector(tcfg.VID_320, temporal=False, device="cpu", width_mult=0.125)
    path = str(tmp_path / "vgg16_reducedfc.pth")
    torch.save(_reducedfc_sd(model), path)
    argv = ["--ckpt", path, "--size", "64", "--width_mult", "0.125"]
    if not mutate:
        res = verify_pretrained_torch.main(argv)
        assert res["pass"] and res["same_grafts"] and res["grafted"] == 15
        assert len(res["sources"]) == 4 and res["worst_rel_delta"] <= 1e-4
        return
    convert = weights.vgg_params_from_state_dict

    def transposed(sd):  # conv3_1's kernel with its H and W swapped
        out = convert(sd)
        out["conv3_1"]["weight"] = out["conv3_1"]["weight"].transpose(2, 3).contiguous()
        return out

    monkeypatch.setattr(weights, "vgg_params_from_state_dict", transposed)
    with pytest.raises(SystemExit) as e:
        verify_pretrained_torch.main(argv)
    assert e.value.code == 1
    res = _last_json(capsys)
    assert not res["pass"] and res["worst_rel_delta"] > 1e-2


def _train(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return train_torch.main(argv + ["--device", "cpu", "--width_mult", "0.125",
                                        "--tcb_channels", "32", "--num_workers", "2",
                                        "--warmup", "1", "--log_every", "1", "--max_iter", "1"])


def test_train_torch_process_loader_and_tensorboard(tmp_path, tiny_cfgs):  # noqa: F811
    _write_voc(str(tmp_path / "voc"), np.random.default_rng(8))
    base = ["--dataset", "voc_tiny", "--data_root", str(tmp_path / "voc"),
            "--image_sets", "2007:trainval", "--batch_size", "2"]
    _, threads = _train(base + ["--loader", "threads", "--save_folder", str(tmp_path / "t")])
    _, procs = _train(base + ["--loader", "processes", "--tensorboard",
                              "--save_folder", str(tmp_path / "p")])
    assert procs["loss"] == threads["loss"] and np.isfinite(procs["loss"])
    events = os.listdir(tmp_path / "p" / "tb")
    assert any(f.startswith("events.out.tfevents") for f in events)
    assert not os.path.exists(tmp_path / "t" / "tb")
    assert train_torch.parse_args(base + ["--loader", "grain"]).loader == "grain"
