"""The port's serving slice: InferenceServer over a resident-bf16 fused2
StreamingDetector with the anchor prefilter, held against the JAX package's,
and the InferenceServer semantics of tests/test_serving.py on the port (lane
state under concurrency, eviction, inactive-lane freezing, latency stats).
TINY_64, width_mult 0.125, 32 TCB channels, seeded numpy frames."""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdrn_tpu import config as jcfg
from tdrn_tpu.inference import StreamingDetector as JStreamingDetector
from tdrn_tpu.models import build_detector as j_build
from tdrn_tpu.serving import InferenceServer as JInferenceServer
from tdrn_tpu.utils.precision import apply_inference_precision as j_precision
from tdrn_tpu_torch import config as tcfg
from tdrn_tpu_torch import weights
from tdrn_tpu_torch.inference import StreamingDetector
from tdrn_tpu_torch.models.detector import build_detector
from tdrn_tpu_torch.serving import InferenceServer, LatencyStats, _Pending
from tdrn_tpu_torch.utils.precision import apply_inference_precision

SMALL = dict(tcb_channels=32, width_mult=0.125)

# --- the slice against the JAX package --------------------------------------

# Both sides run the resident-bf16 profile, whose bf16 convs round at the
# same points but sum in other orders (tests/test_torch_port_stage.py), so
# near-equal scores may swap ranks. Compared per request: the sorted score
# lists, relative to their max (measured 4.8e-3); the share of the port's
# detections that the JAX list holds with the same class, box within 1e-2 and
# score within 1e-2 (measured at least 0.985); and at the end the carried
# state, relative to max|ref| per scale (measured 8.2e-3).
SCORE_REL_TOL = 2e-2
MATCH_SHARE = 0.95
STATE_REL_TOL = 5e-2


def _matched_share(t, j):
    tb, ts, tc = t
    jb, js, jc = (np.asarray(a) for a in j)
    hits = [
        np.any((jc == tc[q]) & np.all(np.abs(jb - tb[q]) < 1e-2, -1) & (np.abs(js - ts[q]) < 1e-2))
        for q in range(len(ts)) if ts[q] > 0
    ]
    return np.mean(hits)


def test_serving_slice_matches_jax():
    """3 streams x 4 steps through submit_sync on both servers; stream s1 is
    reset before step 2. prefilter 128 is below TINY_64's 255 priors, so the
    prefilter runs (and overflows: every anchor of the random model clears
    conf_thresh)."""
    cfg_j = dataclasses.replace(jcfg.TINY_64, fused_cascade=True)
    cfg_t = dataclasses.replace(tcfg.TINY_64, fused_cascade=True)
    jmodel = j_build(cfg_j, temporal=True, stem="fused2", **SMALL)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, None))
    jm16, jp16 = j_precision(jmodel, params, "bf16")
    model = weights.load_jax_params(
        build_detector(cfg_t, stem="fused2", device="cpu", **SMALL), params
    )
    m16 = apply_inference_precision(model, "bf16")
    jsrv = JInferenceServer(
        JStreamingDetector(jm16, jp16, num_streams=3, prefilter=128), dispatch_thread=False
    )
    tdet = StreamingDetector(m16, num_streams=3, prefilter=128, device="cpu")
    tsrv = InferenceServer(tdet, dispatch_thread=False)
    frames = np.random.default_rng(0).integers(0, 256, (4, 3, 64, 64, 3), dtype=np.uint8)
    try:
        for i in range(4):
            if i == 2:
                jsrv.reset_stream("s1")
                tsrv.reset_stream("s1")
            for s in range(3):
                j = jsrv.submit_sync(f"s{s}", frames[i, s])
                t = tsrv.submit_sync(f"s{s}", frames[i, s])
                assert t[0].shape == (cfg_t.top_k, 4) and t[1].dtype == np.float32
                js = np.asarray(j[1])
                assert np.abs(t[1] - js).max() / js.max() < SCORE_REL_TOL, (i, s)
                assert _matched_share(t, j) >= MATCH_SHARE, (i, s)
        assert tsrv.steps == jsrv.steps == 12 and tsrv.frames == 12
        assert tsrv.overflow_frames == jsrv.overflow_frames > 0
        for ts, js in zip(tdet.state, jsrv.det._state):
            assert ts.dtype == torch.bfloat16
            ref = np.asarray(js, "f4")
            got = ts.float().numpy().transpose(0, 2, 3, 1)
            assert np.abs(got - ref).max() / np.abs(ref).max() < STATE_REL_TOL
    finally:
        jsrv.close()
        tsrv.close()


# --- InferenceServer semantics on the port ----------------------------------


@pytest.fixture(scope="module")
def model():
    return build_detector(tcfg.TINY_64, temporal=True, device="cpu", **SMALL)


def _frame(rng):
    return rng.randint(0, 255, (64, 64, 3), np.uint8)


def _det(model, lanes):
    return StreamingDetector(model, num_streams=lanes, top_k=10, device="cpu")


def make_server(model, lanes=2, window_ms=1.0):
    return InferenceServer(_det(model, lanes), window_ms=window_ms)


def test_inactive_lane_state_frozen(model):
    """A lane that skips steps gives the same sequence as one that runs back
    to back (its state does not advance on other streams' steps)."""
    rng = np.random.RandomState(0)
    f1, f2 = _frame(rng), _frame(rng)
    det = _det(model, 1)
    r1 = det.detect(f1[None])
    r2 = det.detect(f2[None])
    srv = make_server(model, lanes=2)
    try:
        a1 = srv.submit("a", f1)
        for _ in range(3):  # other-stream traffic while stream a's lane idles
            srv.submit("b", _frame(rng))
        a2 = srv.submit("a", f2)
        np.testing.assert_allclose(a1[1], r1.scores[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(a2[1], r2.scores[0].numpy(), atol=1e-5)
    finally:
        srv.close()


def test_parallel_streams_match_sequential(model):
    rng = np.random.RandomState(1)
    frames = {s: [_frame(rng) for _ in range(3)] for s in ("s0", "s1")}
    want = {}
    for s, fs in frames.items():
        det = _det(model, 1)
        want[s] = [det.detect(f[None]).scores[0].numpy() for f in fs]
    srv = make_server(model, lanes=2, window_ms=2.0)
    got = {s: [] for s in frames}
    errs = []

    def client(s):
        try:
            for f in frames[s]:
                got[s].append(srv.submit(s, f)[1])
        except Exception as e:  # pragma: no cover
            errs.append(e)

    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        for s in frames:
            assert len(got[s]) == 3
            for g, w in zip(got[s], want[s]):
                np.testing.assert_allclose(g, w, atol=1e-5)
        assert srv.frames == 6
    finally:
        srv.close()


def test_lru_eviction_resets_lane(model):
    f = _frame(np.random.RandomState(2))
    srv = make_server(model, lanes=1)
    try:
        first = srv.submit("x", f)
        srv.submit("y", f)  # evicts x (one lane)
        again = srv.submit("x", f)  # x gets a lane anew, with a fresh state
        np.testing.assert_allclose(first[1], again[1], atol=1e-5)
    finally:
        srv.close()


def test_evicted_stream_pending_requests_fail(model):
    """Eviction leaves none of the old stream's queued frames in the lane."""
    srv = InferenceServer(_det(model, 1), dispatch_thread=False)
    try:
        with srv._lock:
            lane_a = srv._assign_lane("a")
            stale = _Pending(np.zeros((64, 64, 3), np.uint8))
            srv._queues[lane_a].append(stale)
            lane_b = srv._assign_lane("b")  # evicts a (one lane)
        assert lane_b == lane_a
        assert stale.event.is_set() and stale.result is None
        assert srv._queues[lane_a] == []
    finally:
        srv.close()


def test_sync_matches_streaming(model):
    rng = np.random.RandomState(3)
    f1, f2 = _frame(rng), _frame(rng)
    det = _det(model, 1)
    r1 = det.detect(f1[None])
    r2 = det.detect(f2[None])
    srv = make_server(model, lanes=2)
    try:
        a1 = srv.submit_sync("a", f1)
        srv.submit_sync("b", _frame(rng))
        a2 = srv.submit_sync("a", f2)
        np.testing.assert_allclose(a1[1], r1.scores[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(a2[1], r2.scores[0].numpy(), atol=1e-5)
        assert a1[0].shape == (10, 4) and a1[2].dtype == np.int32
    finally:
        srv.close()


def test_latency_percentiles():
    st = LatencyStats(cap=100)
    assert st.snapshot() == {"n": 0}
    for ms in range(1, 101):  # 1..100 ms
        st.record(ms / 1e3)
    snap = st.snapshot()
    assert snap["n"] == 100
    assert 50 <= snap["p50_ms"] <= 52
    assert 90 <= snap["p90_ms"] <= 92
    assert 99 <= snap["p99_ms"] <= 100
    assert snap["max_ms"] == 100.0
    for ms in range(200, 260):  # a ring: old entries fall out
        st.record(ms / 1e3)
    assert st.snapshot()["n"] == 100


def test_server_records_latency(model):
    srv = make_server(model, lanes=2)
    try:
        f = _frame(np.random.RandomState(5))
        srv.submit_sync("s", f)
        srv.submit("s", f)
        snap = srv.latency.snapshot()
        assert snap["n"] == 2 and snap["p50_ms"] > 0
    finally:
        srv.close()
