"""The readers of the program's own ranges and counters, on synthetic
totals and records: each reads what the program counted, and None where
the program ran no such range or counter, or has none (the parent of the
change that added them)."""

import sys

import pytest

from perfbench import bench

STEP = ("replay.stage_ms.clips", "replay.launch_ms.clips")
SETUP = ("setup.capture_s.clips", "setup.build_s.clips")
TOTALS = {"tdrn::detect": [50, 0.40], "tdrn::stage": [50, 0.30], "tdrn::stage_wait": [50, 0.01],
          "tdrn::replay": [50, 0.004], "tdrn::clone": [50, 0.006]}


def _profile(gaps, steps=50):
    return {"steps": steps, "breakdown": {"device_ops": [], "idle_gaps": gaps}}


@pytest.fixture
def program(monkeypatch):
    """The program's modules, their totals and counters fresh."""
    from tdrn_tpu_torch import _build, inference
    from tdrn_tpu_torch.utils import logging

    monkeypatch.setattr(logging.span, "totals", {})
    monkeypatch.setattr(inference.capture, "seconds", 0.0)
    monkeypatch.setattr(_build.library, "seconds", {})
    return logging, inference, _build


def read(name, record=None):
    return bench.reader(name).read(name, record or {})


@pytest.mark.parametrize("name,want", [("replay.stage_ms.clips", 6.0),
                                       ("replay.launch_ms.clips", 0.2)])
def test_step_readers_are_ms_a_detect(program, name, want):
    program[0].span.totals.update({k: list(v) for k, v in TOTALS.items()})
    assert read(name) == pytest.approx(want)


@pytest.mark.parametrize("name", STEP)
def test_step_readers_none_without_replays(program, name):
    assert read(name) is None  # no detect ran: no totals
    program[0].span.totals["tdrn::detect"] = [3, 0.1]  # the CPU path: no graph
    assert read(name) is None


@pytest.mark.parametrize("gaps,totals,want", [
    ([["perfbench__fetch", 0.02], ["tdrn__stage_wait", 0.004], ["tdrn__detect", 0.006]],
     TOTALS, 0.2),
    ([["perfbench__detect", 0.03]], TOTALS, 0.0),  # ranges recorded, no idle in them
    ([["perfbench__detect", 0.03]], {}, None),  # a program with no ranges
])
def test_idle_reader(program, gaps, totals, want):
    program[0].span.totals.update(totals)
    got = read("replay.idle_ms.clips", {"profile": _profile(gaps)})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("record", [{}, {"profile": None}, {"profile": _profile([], steps=0)}])
def test_idle_reader_none_untraced(program, record):
    program[0].span.totals.update(TOTALS)
    assert read("replay.idle_ms.clips", record) is None


def test_setup_readers(program):
    _, inference, _build = program
    assert [read(n) for n in SETUP] == [None, None]  # nothing captured or loaded
    inference.capture.seconds = 1.25
    _build.library.seconds.update(cascade=0.05, nms_suppress=0.07)
    assert read(SETUP[0]) == pytest.approx(1.25)
    assert read(SETUP[1]) == pytest.approx(0.12)


@pytest.mark.parametrize("name", STEP + SETUP + ("replay.idle_ms.clips",))
def test_readers_none_without_the_program(monkeypatch, name):
    for mod in ("tdrn_tpu_torch.utils.logging", "tdrn_tpu_torch.inference",
                "tdrn_tpu_torch._build"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    assert read(name, {"profile": _profile([["perfbench__detect", 0.03]])}) is None
