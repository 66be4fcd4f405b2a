"""A configuration brings its plain reference, and a kernel its bound, as
new files that the harness finds by name, with no file of perfbench/
edited: a third configuration in a temporary tree (the harness's search
paths pointed at it) whose reference wraps reference/model.py and doubles
the ODM confidences, and a kernel file that names a made-up trace name.
The committed configurations keep reference/model.py itself."""

import importlib
import json
import os
import shutil
import sys

import pytest
import torch

import perfbench.kernels
import perfbench.reference
from perfbench import bench, roofline, run, trace
from perfbench.reference import model as ref_model
from perfbench.tests.conftest import TINY, config_workloads, tiny_cell

CPU = torch.device("cpu")
THIRD = "tiny_doubled"
CELL = f"{THIRD}.clips16_ahead"
MADE_UP = "void (anonymous namespace)::made_up_kernel<4>(Params)"

REFERENCE = '''"""reference/model.py with the ODM confidences doubled, and the TCB
kept in float32 under bf16; records each call."""

from perfbench.reference import model

FP32_GROUPS = model.FP32_GROUPS + ("tcb",)
CALLS = []


def param_spec(cfg):
    CALLS.append(("param_spec", None))
    return model.param_spec(cfg)


def zero_state(cfg, batch, device):
    CALLS.append(("zero_state", str(device)))
    return model.zero_state(cfg, batch, device)


def preprocess(cfg, frames_u8):
    CALLS.append(("preprocess", frames_u8.device.type))
    return model.preprocess(cfg, frames_u8)


def forward(cfg, p, x, state, lowp=None):
    CALLS.append(("forward", x.device.type))
    (arm_loc, arm_conf, odm_loc, odm_conf), new_state = model.forward(cfg, p, x, state, lowp)
    return (arm_loc, arm_conf, odm_loc, 2.0 * odm_conf), new_state
'''

KERNEL = '''"""A made-up kernel: 1 us a frame."""

NAMES = ("made_up_kernel",)


def bound_s(cfg, batch):
    return 1e-6 * batch
'''


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _search(monkeypatch, root, here):
    """Point the harness's search paths at the tree ``root``."""
    monkeypatch.setattr(bench, "ROOT", str(root))
    monkeypatch.setattr(bench, "HERE", str(here))
    for pkg in (perfbench.reference, perfbench.kernels):
        sub = os.path.join(here, pkg.__name__.rsplit(".", 1)[1])
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, sub])
    importlib.invalidate_caches()


@pytest.fixture
def third(tmp_path, monkeypatch):
    """BENCHMARK.json and perfbench/'s data as committed, plus a third
    configuration's files and entries, in a temporary tree."""
    here = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(bench.HERE, sub), here / sub)
    spec = bench.benchmark()
    vgg = bench.find_cell("vgg16_vid320.clips16_ahead")
    spec["configs"].append({"name": THIRD, "source": "https://arxiv.org/abs/1807.08638",
                            "file": f"perfbench/configs/{THIRD}.json", "reduced": [],
                            "why": "a reference of its own"})
    spec["workloads"].append({"name": CELL, "config": THIRD, "traffic": "clips16_ahead",
                              "chips": 1, "why": "the third configuration's cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    _write(tmp_path / "BENCHMARK.json", json.dumps(spec))
    cfg = dict(vgg.config, **TINY, name=THIRD, reference="doubled")
    _write(here / "configs" / f"{THIRD}.json", json.dumps(cfg))
    _write(here / "limits" / f"{CELL}.json", json.dumps(vgg.limits))
    _write(here / "reference" / "doubled.py", REFERENCE)
    _write(here / "kernels" / "K9.py", KERNEL)
    for name in ("perfbench.reference.doubled", "perfbench.kernels.K9"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    _search(monkeypatch, tmp_path, here)
    return here


def test_a_third_configuration_joins_with_new_files(third):
    cell = bench.find_cell(CELL)
    assert cell.config["reference"] == "doubled" and cell.limits == bench.load_json(
        os.path.join(third, "limits", f"{CELL}.json"))
    ref = bench.reference(cell.config)
    assert ref is not ref_model and ref.__file__ == str(third / "reference" / "doubled.py")
    cfg = tiny_cell(CELL).config

    weights = bench.make_weights(cfg, 5, CPU)
    assert ("param_spec", None) in ref.CALLS
    plain = bench.make_weights(dict(cfg, reference="model"), 5, CPU)
    assert all(torch.equal(weights[k], plain[k]) for k in plain) and weights.keys() == plain.keys()
    bf16 = bench.make_weights(dict(cfg, precision="bf16"), 5, CPU)  # FP32_GROUPS read from it
    assert bf16["tcb.tcb0.conv1.weight"].dtype == torch.float32
    assert bf16["backbone.conv1_1.weight"].dtype == torch.bfloat16

    # streams.replay: the program against the doubled reference is not correct.
    ref.CALLS.clear()
    res = run.run_cell(tiny_cell(CELL), 11, 0.5, False, device="cpu")
    assert not res["correct"] and res["checked"]["frame_gap"] > cell.limits["frame_gap"]
    assert {("zero_state", "cpu"), ("preprocess", "cpu"), ("forward", "cpu")} <= set(ref.CALLS)

    ref.CALLS.clear()
    assert roofline.model_flops(cfg) == roofline.model_flops(dict(cfg, reference="model"))
    assert ("forward", "meta") in ref.CALLS

    bounds = roofline.bounds_s(cfg, 16)
    assert list(bounds) == ["K1", "K2", "K3", "K4", "K9"] and bounds["K9"] == 16e-6
    assert roofline.kernel_of(MADE_UP) == "K9" and trace.kind(MADE_UP) == "port"
    record = {"config": cfg, "batch": 16,
              "profile": {"kernel_s": {MADE_UP: 0.002, "sm90_xmma_fprop_implicit_gemm": 0.5},
                          "kernel_n": {MADE_UP: 10, "sm90_xmma_fprop_implicit_gemm": 10}}}
    reader = bench.reader("kernels.roofline.clips")
    assert reader.__file__ == str(third / "metrics" / "kernels.roofline.py")
    assert reader.read("kernels.roofline.clips", record) == pytest.approx(100.0 * 16e-5 / 0.002)


def test_a_trace_name_of_two_kernel_files_is_an_error(tmp_path, monkeypatch):
    here = tmp_path / "perfbench"
    _write(here / "kernels" / "K9.py", KERNEL)
    _write(here / "kernels" / "K8.py", 'NAMES = ("made_up",)\n\n\ndef bound_s(cfg, batch):\n'
           '    return None\n')
    for name in ("perfbench.kernels.K8", "perfbench.kernels.K9"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    _search(monkeypatch, tmp_path, here)
    assert roofline.kernel_of("cascade_kernel") == "K1"
    with pytest.raises(ValueError, match="K8.*K9"):
        roofline.kernel_of(MADE_UP)


@pytest.mark.parametrize("config,workload", config_workloads())
def test_committed_configurations_use_reference_model(config, workload):
    assert bench.reference(bench.find_cell(workload).config) is ref_model

