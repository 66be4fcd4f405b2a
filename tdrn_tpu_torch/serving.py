"""Serving runtime: micro-batched streaming inference (the port of ``tdrn_tpu/serving.py``).

Concurrent clients submit frames for independent video streams; a dispatcher
thread coalesces the pending requests into one batched step of a
``StreamingDetector``, and each stream's temporal state lives in its lane of
the device-resident state.

Lane policy: a stream id is pinned to a lane on first use (LRU eviction when
full; the evicted stream's queued requests fail and the lane's state is reset
for its new stream). At most one frame per lane per step keeps each stream's
frames in order.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from tdrn_tpu_torch.data import image


class _Pending:
    __slots__ = ("frame", "event", "result")

    def __init__(self, frame: np.ndarray):
        self.frame = frame
        self.event = threading.Event()
        self.result: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


class LatencyStats:
    """Ring of the last N request latencies -> percentile snapshot: end-to-end
    request latency (enqueue -> result ready, the coalescing window and any
    queueing included, not only device time)."""

    def __init__(self, cap: int = 2048):
        self._lat: List[float] = []
        self._cap = cap
        self._lock = threading.Lock()

    def record(self, seconds: float):
        with self._lock:
            self._lat.append(seconds)
            if len(self._lat) > self._cap:
                del self._lat[: len(self._lat) - self._cap]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = list(self._lat)
        if not lat:
            return {"n": 0}
        a = np.sort(np.asarray(lat, np.float64)) * 1e3
        q = lambda p: round(float(a[min(len(a) - 1, int(p * len(a)))]), 3)
        return {"n": len(a), "p50_ms": q(0.5), "p90_ms": q(0.9),
                "p99_ms": q(0.99), "max_ms": round(float(a[-1]), 3)}


class InferenceServer:
    """Micro-batching scheduler over a StreamingDetector."""

    def __init__(self, detector, window_ms: float = 3.0, dispatch_thread: bool = True):
        """dispatch_thread=False: no dispatcher thread is started; the owner
        calls run_dispatch_forever() itself, or uses submit_sync."""
        self.det = detector
        self.lanes = detector.num_streams
        self.size = detector.cfg.size
        self.window_s = window_ms / 1e3
        self._lane_of: "OrderedDict[str, int]" = OrderedDict()  # stream -> lane (LRU)
        self._free: List[int] = list(range(self.lanes))
        self._queues: Dict[int, List[_Pending]] = {i: [] for i in range(self.lanes)}
        self._lock = threading.Lock()
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self.steps = 0
        self.frames = 0
        # Frames where the anchor prefilter's exactness precondition failed
        # (ops/detection.py prefilter_overflow); 0 when the exact path is on.
        self.overflow_frames = 0
        self.latency = LatencyStats()
        # One step before the dispatcher starts, so the first request does
        # not pay for building the kernels and capturing the step's CUDA
        # graph. The capture runs here, on the constructing thread, while no
        # thread of the server launches CUDA work: the dispatcher starts
        # after it, and client threads touch only the host.
        zeros = np.zeros((self.lanes, self.size, self.size, 3), np.uint8)
        self.det.detect(zeros, active=np.zeros((self.lanes,), np.float32))
        self.det.reset()
        self._thread = None
        if dispatch_thread:
            self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
            self._thread.start()

    def run_dispatch_forever(self):
        """Run the dispatch loop on the calling thread (blocks until close())."""
        self._dispatch_loop()

    # ------------------------------------------------------------- client API
    def _fit(self, frame_u8: np.ndarray) -> np.ndarray:
        if frame_u8.shape[:2] != (self.size, self.size):
            frame_u8 = image.resize(np.asarray(frame_u8, np.uint8), self.size)
        return frame_u8.astype(np.uint8)

    def submit(self, stream_id: str, frame_u8: np.ndarray, timeout: float = 120.0):
        """Blocking detect for one frame of one stream.

        frame_u8: (H, W, 3) uint8 RGB; a frame that is not size x size is
        resized on the host (data/image.py, equal to cv2.resize). Returns
        (boxes01 (K,4), scores (K,), classes (K,)) as numpy.
        """
        req = _Pending(self._fit(frame_u8))
        t0 = time.monotonic()
        with self._lock:
            lane = self._assign_lane(stream_id)
            self._queues[lane].append(req)
        self._wakeup.set()
        if not req.event.wait(timeout):
            raise TimeoutError(f"inference timed out for stream {stream_id}")
        self.latency.record(time.monotonic() - t0)
        if req.result is None:
            raise RuntimeError(
                f"stream {stream_id} was evicted under lane pressure before "
                "this frame ran; resubmit to start a fresh stream"
            )
        return req.result

    def submit_sync(self, stream_id: str, frame_u8: np.ndarray):
        """Synchronous detect on the calling thread, without the dispatcher:
        lane assignment, one step with only this lane active, and the fetch.
        Not for concurrent use from several threads."""
        frame_u8 = self._fit(frame_u8)
        t0 = time.monotonic()
        with self._lock:
            lane = self._assign_lane(stream_id)
        frames = np.zeros((self.lanes, self.size, self.size, 3), np.uint8)
        frames[lane] = frame_u8
        active = np.zeros((self.lanes,), np.float32)
        active[lane] = 1.0
        out = self.det.detect(frames, active=active)
        self.steps += 1
        self.frames += 1
        if out.prefilter_overflow is not None:
            self.overflow_frames += int(out.prefilter_overflow[lane])
        result = tuple(t[lane].cpu().numpy() for t in (out.boxes, out.scores, out.classes))
        self.latency.record(time.monotonic() - t0)
        return result

    def reset_stream(self, stream_id: str):
        with self._lock:
            lane = self._lane_of.get(stream_id)
        if lane is not None:
            self.det.reset([lane])

    def close(self):
        self._stop.set()
        self._wakeup.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # ---------------------------------------------------------------- internals
    def _assign_lane(self, stream_id: str) -> int:
        if stream_id in self._lane_of:
            self._lane_of.move_to_end(stream_id)
            return self._lane_of[stream_id]
        if self._free:
            lane = self._free.pop()
        else:  # LRU-evict the stalest stream; its lane state resets on reuse
            evicted, lane = self._lane_of.popitem(last=False)
            # Fail the evicted stream's queued frames: left in the queue they
            # would run through the new stream's temporal state.
            for req in self._queues[lane]:
                req.result = None
                req.event.set()
            self._queues[lane] = []
        self._lane_of[stream_id] = lane
        self.det.reset([lane])
        return lane

    def _dispatch_loop(self):
        frames = np.zeros((self.lanes, self.size, self.size, 3), np.uint8)
        while not self._stop.is_set():
            self._wakeup.wait(timeout=0.1)
            self._wakeup.clear()
            if self._stop.is_set():
                return
            # Coalescing window: let concurrent requests join this step.
            time.sleep(self.window_s)
            with self._lock:
                batch: List[Tuple[int, _Pending]] = []
                for lane, q in self._queues.items():
                    if q:
                        batch.append((lane, q.pop(0)))  # one per lane per step
                more_pending = any(self._queues.values())
            if not batch:
                continue
            active = np.zeros((self.lanes,), np.float32)
            for lane, req in batch:
                frames[lane] = req.frame
                active[lane] = 1.0
            out = self.det.detect(frames, active=active)
            boxes, scores, classes = (t.cpu().numpy() for t in (out.boxes, out.scores, out.classes))
            if out.prefilter_overflow is not None:
                ovf = out.prefilter_overflow.cpu().numpy()
                self.overflow_frames += int(sum(ovf[lane] for lane, _ in batch))
            for lane, req in batch:
                req.result = (boxes[lane], scores[lane], classes[lane])
                req.event.set()
            self.steps += 1
            self.frames += len(batch)
            if more_pending:
                self._wakeup.set()
