"""Nothing the harness loads is JAX or the JAX package: top-level module
names compared whole (the port's name begins with the JAX package's)."""

import os
import subprocess
import sys

from perfbench import run
from perfbench.tests.conftest import ROOT

PROBE = """
import sys
sys.path.insert(0, {root!r})
from perfbench import run
from perfbench.tests.conftest import tiny_cell
import torch
torch.set_num_threads(2)
for w in {workloads!r}:
    assert run.run_cell(tiny_cell(w), 3, 0.5, True, device="cpu")["correct"]
print(",".join(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tdrn_tpu_torch_fake.sub", sys)
    assert "tdrn_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "tdrn_tpu.config", sys)
    assert run.loaded_forbidden() == ["tdrn_tpu"]


def test_a_run_loads_no_jax():
    from perfbench.tests.conftest import workloads

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, workloads=workloads())],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "tdrn_tpu_torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)
