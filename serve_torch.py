"""Inference server (CLI) of the PyTorch / CUDA port: the counterpart of ``serve.py``.

A small stdlib HTTP server over the port's micro-batching scheduler
(tdrn_tpu_torch/serving.py): concurrent clients post encoded frames (JPEG,
PNG) for independent video streams and get JSON detections; each stream's
temporal state stays on the card in its lane between requests.

    POST /detect?stream=<id>&thresh=0.4   body: image bytes -> JSON detections
    POST /reset?stream=<id>               reset a stream's temporal state
    GET  /healthz                         liveness + stats

Example:
    python serve_torch.py --checkpoint weights_torch/ --port 8000 --lanes 8
    curl -X POST --data-binary @frame.jpg "localhost:8000/detect?stream=cam1"

The checkpoint is the port's (tdrn_tpu_torch/train/checkpoint.py;
tools/orbax_to_torch.py converts a JAX package checkpoint). Images are
decoded with PIL and resized by tdrn_tpu_torch/data/image.py (no OpenCV).
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from tdrn_tpu_torch.data import VID_CLASSES, VOC_CLASSES, image
from tdrn_tpu_torch.inference import StreamingDetector, load_inference_model
from tdrn_tpu_torch.serving import InferenceServer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="TDRN inference server (PyTorch / CUDA port)")
    ap.add_argument("--dataset", default=None,
                    help="config name; defaults to the checkpoint's meta (else vid_320)")
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--stem", default=None, choices=["conv", "poly", "poly2", "s2d", "fused", "fused2"],
                    help="override the checkpoint's stem (fused/fused2 = the K3/K4 kernels)")
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--lanes", type=int, default=8, help="concurrent stream lanes")
    ap.add_argument("--window_ms", type=float, default=3.0, help="micro-batch window")
    ap.add_argument("--random_init", action="store_true",
                    help="serve an untrained model (smoke testing)")
    ap.add_argument("--precision", default="fp32", choices=["fp32", "bf16", "int8"],
                    help="bf16 = resident-bf16 feature pyramid, fp32 "
                         "heads/detect (utils/precision.py)")
    ap.add_argument("--int8_scales", default=None,
                    help="activation-scales json for --precision int8 "
                         "(from eval_torch.py --precision int8 --save_scales)")
    ap.add_argument("--backbone_norm", default=None, choices=["frozen", "group"],
                    help="resnet norm override (identical param trees restore "
                         "silently into the wrong norm)")
    ap.add_argument("--mode", default="sync", choices=["sync", "threaded"],
                    help="sync: single-threaded HTTP, detect inline on the "
                         "main thread; threaded: micro-batched dispatcher + "
                         "concurrent handlers")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def build_server(args):
    """(InferenceServer, class names) for the parsed arguments."""
    try:
        model, cfg, _, _ = load_inference_model(
            args.checkpoint, dataset=args.dataset, backbone=args.backbone,
            stem=args.stem, precision=args.precision,
            int8_scales=args.int8_scales,
            backbone_norm=args.backbone_norm,
            temporal=True, random_init=args.random_init, dataset_fallback="vid_320",
            device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(str(e))
    class_names = VID_CLASSES if cfg.name.startswith("vid") else VOC_CLASSES
    det = StreamingDetector(model, num_streams=args.lanes, device=args.device)
    return (
        InferenceServer(
            det, window_ms=args.window_ms, dispatch_thread=(args.mode == "threaded")
        ),
        class_names,
    )


def detect_request(server, class_names, sync: bool, stream: str, rgb: np.ndarray,
                   thresh: float) -> dict:
    """One /detect request after its decode: (H, W, 3) uint8 RGB of one
    stream -> the JSON body, boxes in the frame's pixels."""
    h, w = rgb.shape[:2]
    if sync:
        boxes, scores, classes = server.submit_sync(stream, rgb)
    else:
        boxes, scores, classes = server.submit(stream, rgb)
    keep = scores >= thresh
    dets = [
        {
            "box": [float(v) for v in (b * [w, h, w, h])],
            "score": float(s),
            "class": class_names[int(c) - 1],
        }
        for b, s, c in zip(boxes[keep], scores[keep], classes[keep])
    ]
    return {"stream": stream, "detections": dets}


def make_handler(server, class_names, sync: bool):
    """The HTTP request handler class over ``server``."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {
                    "ok": True, "steps": server.steps,
                    "frames": server.frames,
                    "prefilter_overflow_frames": server.overflow_frames,
                    "latency": server.latency.snapshot(),
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            stream = q.get("stream", ["default"])[0]
            if url.path == "/reset":
                server.reset_stream(stream)
                self._json(200, {"ok": True})
                return
            if url.path != "/detect":
                self._json(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            rgb = image.decode(self.rfile.read(length))
            if rgb is None:
                self._json(400, {"error": "could not decode image"})
                return
            thresh = float(q.get("thresh", ["0.3"])[0])
            self._json(200, detect_request(server, class_names, sync, stream, rgb, thresh))

    return Handler


class _ThreadingHTTPServer(ThreadingHTTPServer):
    # The listen backlog: socketserver's default of 5 drops the SYNs of
    # concurrent clients past it, and each dropped one waits a 1 s
    # retransmit (p99 1.08 s at 16 clients on the H100's host).
    request_queue_size = 128


def make_httpd(args, server, class_names):
    """The HTTP server on (args.host, args.port); port 0 takes a free one."""
    sync = args.mode == "sync"
    cls = HTTPServer if sync else _ThreadingHTTPServer
    return cls((args.host, args.port), make_handler(server, class_names, sync))


def main(argv=None):
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)
    args = parse_args(argv)
    server, class_names = build_server(args)
    httpd = make_httpd(args, server, class_names)
    host, port = httpd.server_address[:2]
    print(f"serving ({args.mode}) on {host}:{port} with {args.lanes} lanes", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    main()
