"""Each cell's traffic runs end to end at tiny size on the CPU through the
plain paths, untraced and traced, and comes out correct; the clips driver
dispatches step t+1 before it reads step t, and reads every step once, in
order, on every lane."""

import pytest
import torch

from perfbench import run
from perfbench.tests.conftest import tiny_cell, workloads


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", workloads())
def test_cell_runs_end_to_end(workload, trace):
    cell = tiny_cell(workload)
    res = run.run_cell(cell, 2**31 + 17, 1.0, bool(trace), device="cpu")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(res["metrics"]) <= {m["name"] for m in wanted}
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in wanted}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    else:
        assert res["profile"]["window_s"] > 0


def test_dispatch_one_step_ahead(monkeypatch):
    from perfbench.drivers import clips_ahead
    from tdrn_tpu_torch.inference import StreamingDetector

    events = []
    detect, finish = StreamingDetector.detect, clips_ahead.Fetcher.finish

    def traced_detect(self, frames, *args, **kwargs):
        out = detect(self, frames, *args, **kwargs)
        events.append(("detect", id(out)))
        self._perfbench_last = out
        return out

    def traced_finish(handle):
        events.append(("fetch", None))
        return finish(handle)

    monkeypatch.setattr(StreamingDetector, "detect", traced_detect)
    monkeypatch.setattr(clips_ahead.Fetcher, "finish", staticmethod(traced_finish))
    seen = {}
    put = clips_ahead.streams.Ring.put

    def record(self, lane, i, result):
        seen.setdefault(lane, []).append(i)
        put(self, lane, i, result)

    monkeypatch.setattr(clips_ahead.streams.Ring, "put", record)
    cell = tiny_cell("vgg16_vid320.clips16_ahead")
    res = run.run_cell(cell, 5, 1.0, False, device="cpu")
    assert res["correct"]
    window = events[int(cell.traffic["warmup_steps"]):]
    kinds = [k for k, _ in window]
    # detect(0), detect(1), fetch(0), detect(2), fetch(1), ..., the last fetch after the loop.
    assert kinds[:2] == ["detect", "detect"] and kinds[2] == "fetch"
    assert all(a == "detect" and b == "fetch" for a, b in zip(kinds[1:-1:2], kinds[2::2]))
    steps = kinds.count("detect")
    assert kinds.count("fetch") == steps
    for lane, idx in seen.items():
        assert idx == list(range(steps)), lane
