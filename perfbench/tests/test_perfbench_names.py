"""Every name in BENCHMARK.json resolves to its files, and the file keeps
the benchmark contract's shape rules."""

import json
import os
import re

import pytest
import torch

from perfbench import bench
from perfbench.tests.conftest import config_workloads, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = bench.benchmark()


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(workload):
    cell = bench.find_cell(workload)
    assert bench.driver(cell.traffic).run
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        assert bench.reader(m["name"]).read


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_is_the_programs_geometry(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = bench.load_json(os.path.join(bench.ROOT, entry["file"]))
    assert cfg["name"] == config and entry["reduced"] == []
    bench.port_config(cfg)  # raises where the file and the program differ


@pytest.mark.parametrize("config,workload", config_workloads())
def test_reference_names_every_program_parameter(config, workload):
    cfg = tiny_cell(workload).config
    model = bench.build_model(cfg, torch.device("cpu"))
    program = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    reference = {n: s for n, s, _ in bench.reference(cfg).param_spec(cfg)}
    assert program == reference
