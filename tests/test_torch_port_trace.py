"""The port's host ranges and counters: ``span`` (utils/logging.py), off
and on; ``tdrn::detect`` once a ``StreamingDetector.detect`` on the CPU
path; the dispatcher's ranges recorded from its own thread under
``profile_trace``, and the server's queue wait; serve_torch.py's /healthz
body. TINY_64, width_mult 0.125, 32 TCB channels, seeded numpy frames."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import serve_torch
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.serving import InferenceServer
from tdrn_tpu_torch.utils.logging import TRACE_FILE, profile_trace, span
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(tcb_channels=32, width_mult=0.125)
SERVE_RANGES = ("tdrn::serve_idle", "tdrn::serve_window", "tdrn::serve_assemble",
                "tdrn::serve_fetch", "tdrn::serve_deliver")


@pytest.fixture(autouse=True)
def fresh_totals():
    span.totals.clear()
    yield
    span.totals.clear()


@pytest.fixture(scope="module")
def model():
    return build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL)


def _frames(rng, *lead):
    return rng.integers(0, 256, (*lead, 64, 64, 3), dtype=np.uint8)


def _ranges(prof, prefix="tdrn::"):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def _on_thread(where: str, fn):
    if where == "main":
        return fn()
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return out[0]


@pytest.mark.parametrize("where", ["main", "other"])
def test_span_off_enters_no_range_and_counts(where, monkeypatch):
    """With no profiler running, no ``record_function`` is made; the totals
    count every closed range all the same."""

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)

    def body():
        with span("tdrn::a"):
            for _ in range(2):
                with span("tdrn::b"):
                    time.sleep(0.001)

    _on_thread(where, body)
    assert span.totals["tdrn::a"][0] == 1 and span.totals["tdrn::b"][0] == 2
    assert span.totals["tdrn::a"][1] >= span.totals["tdrn::b"][1] >= 0.002


@pytest.mark.parametrize("where", ["main", "other"])
def test_span_on_nests_and_counts(where):
    """A profiler started on the main thread turns the gate on in every
    thread (the flag is process-wide); the totals count each closed range."""

    def body():
        with span("tdrn::outer"):
            for _ in range(3):
                with span("tdrn::inner"):
                    time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _on_thread(where, body)
    assert span.totals["tdrn::outer"][0] == 1 and span.totals["tdrn::inner"][0] == 3
    assert span.totals["tdrn::outer"][1] >= span.totals["tdrn::inner"][1] >= 0.006
    if where == "main":  # another thread's ranges need a profiler of all threads
        outer = next(e for e in _ranges(prof) if e.name == "tdrn::outer")
        inner = [e for e in _ranges(prof) if e.name == "tdrn::inner"]
        assert len(inner) == 3
        for e in inner:
            assert outer.time_range.start <= e.time_range.start <= e.time_range.end
            assert e.time_range.end <= outer.time_range.end
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    with span("tdrn::after"):  # the profiler has stopped: counted, not recorded
        pass
    assert span.totals["tdrn::after"][0] == 1 and not _ranges(prof)


@pytest.mark.parametrize("chunk", [1, 2])
def test_detect_is_one_range_a_call(model, chunk):
    det = StreamingDetector(model, num_streams=2, top_k=10, chunk=chunk, device="cpu")
    rng = np.random.default_rng(chunk)
    lead = (2,) if chunk == 1 else (chunk, 2)
    det.detect(_frames(rng, *lead))  # before the profiler: counted, not recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            det.detect(_frames(rng, *lead))
    assert [e.name for e in _ranges(prof)] == ["tdrn::detect"] * 3
    assert span.totals["tdrn::detect"][0] == 4
    assert det.captures == 0  # the CPU path runs eagerly


@pytest.fixture(scope="module")
def served(model, tmp_path_factory):
    """6 requests of 2 streams through the dispatcher under ``profile_trace``
    started on the main thread: (events, totals, queue_wait snapshot,
    requests, the main thread's profiler thread id, the names in the
    written trace)."""
    span.totals.clear()
    srv = InferenceServer(StreamingDetector(model, num_streams=2, top_k=10, device="cpu"),
                          window_ms=1.0)
    rng = np.random.default_rng(7)
    frames = _frames(rng, 2, 3)
    errors = []

    def client(s):
        try:
            for i in range(3):
                srv.submit(f"s{s}", frames[s, i])
        except Exception as e:  # re-raised on the main thread
            errors.append(e)

    out = str(tmp_path_factory.mktemp("served_trace"))
    try:
        with profile_trace(out) as prof:
            with span("tdrn::test_main"):
                clients = [threading.Thread(target=client, args=(s,)) for s in range(2)]
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(timeout=120)
                time.sleep(0.3)  # the dispatcher's next idle wait (0.1 s) closes
        assert not errors, errors
        assert all(not t.is_alive() for t in clients)
        events = [(e.name, e.thread) for e in _ranges(prof)]
        main = next(th for n, th in events if n == "tdrn::test_main")
        with open(os.path.join(out, TRACE_FILE)) as f:
            written = {e.get("name") for e in json.load(f)["traceEvents"]}
        yield events, dict(span.totals), srv.queue_wait.snapshot(), 6, main, written
    finally:
        srv.close()
        span.totals.clear()


@pytest.mark.parametrize("name", SERVE_RANGES + ("tdrn::detect",))
def test_dispatcher_range_is_recorded_from_its_thread(served, name):
    events, totals, _, _, main, written = served
    threads = {th for n, th in events if n == name}
    dispatcher = {th for n, th in events if n == "tdrn::serve_window"}
    assert len(dispatcher) == 1 and main not in dispatcher
    assert threads == dispatcher
    assert totals[name][0] >= 1
    assert name in written  # the operator's trace.json holds it


def test_dispatcher_queue_wait_counts_the_served_requests(served):
    events, totals, queue_wait, requests, _, _ = served
    assert queue_wait["n"] == requests
    assert 0 <= queue_wait["p50_ms"] <= queue_wait["max_ms"]
    # A step a batch: each batch is assembled, run, fetched and delivered once.
    steps = sum(1 for n, _ in events if n == "tdrn::serve_deliver")
    assert 1 <= steps <= requests
    for name in ("tdrn::serve_fetch", "tdrn::detect"):
        assert sum(1 for n, _ in events if n == name) == steps


HEALTH_KEYS = {"ok", "steps", "frames", "prefilter_overflow_frames", "latency", "queue_wait",
               "spans", "setup"}
# Closed before a request's result is handed over, so counted by the time
# its client reads /healthz (serve_deliver closes just after).
HEALTH_SPANS = {"sync": {"tdrn::detect"},
                "threaded": {"tdrn::detect"} | set(SERVE_RANGES) - {"tdrn::serve_deliver"}}


@pytest.mark.parametrize("mode", ["sync", "threaded"])
def test_healthz_keys(model, mode):
    srv = InferenceServer(StreamingDetector(model, num_streams=2, top_k=10, device="cpu"),
                          window_ms=1.0, dispatch_thread=mode == "threaded")
    rng = np.random.default_rng(3)
    try:
        for i, frame in enumerate(_frames(rng, 2)):
            if mode == "sync":
                srv.submit_sync(f"s{i}", frame)
            else:
                srv.submit(f"s{i}", frame)
        body = serve_torch.health(srv)
    finally:
        srv.close()
    assert set(body) == HEALTH_KEYS and body["ok"] and body["frames"] == 2
    assert body["latency"]["n"] == 2
    assert body["queue_wait"]["n"] == (2 if mode == "threaded" else 0)  # sync has no queue
    assert HEALTH_SPANS[mode] <= set(body["spans"])
    assert body["spans"]["tdrn::detect"]["calls"] >= 1 and body["spans"]["tdrn::detect"]["s"] > 0
    assert json.loads(json.dumps(body)) == body  # served as JSON
    assert set(body["setup"]) == {"captures", "capture_s", "library_s", "compiled"}
    if not torch.cuda.is_available():
        assert body["setup"]["captures"] == 0 and body["setup"]["library_s"] == 0
