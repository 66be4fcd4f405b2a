"""On the card: a replayed ``detect`` under the profiler records the
program's step ranges once each, nested in ``tdrn::detect``, and the
capture counter adds the detector's capture."""

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from perfbench import bench
from perfbench.tests.conftest import tiny_cell

STEP = ("tdrn::stage", "tdrn::stage_wait", "tdrn::replay", "tdrn::clone")


def test_replayed_detect_ranges_and_capture_counter(card):
    from tdrn_tpu_torch import inference
    from tdrn_tpu_torch.utils.logging import span

    cfg = tiny_cell("vgg16_vid320.clips16_ahead").config
    model = bench.build_model(cfg, card)
    before = inference.capture.seconds
    det = inference.StreamingDetector(model, num_streams=2, device=card)
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    det.detect(frames)  # captures
    det.detect(frames)
    assert det.captures == 1 and inference.capture.seconds > before
    span.totals.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det.detect(frames)
    # Host ranges only: each also has a mirror on the device's timeline.
    ranges = [e for e in prof.events()
              if e.name.startswith("tdrn::") and e.device_type == DeviceType.CPU]
    detect = [e for e in ranges if e.name == "tdrn::detect"]
    assert len(detect) == 1
    d = detect[0].time_range
    for name in STEP:
        got = [e.time_range for e in ranges if e.name == name]
        assert len(got) == 1, (name, len(got))
        assert d.start <= got[0].start <= got[0].end <= d.end, name
        assert span.totals[name][0] == 1
    assert span.totals["tdrn::detect"][0] == 1
    span.totals.clear()
