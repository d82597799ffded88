"""rtdm-serve: micro-batching HTTP inference server over saved engines.

Counterpart of ``rtdm_tpu/cli/serve.py``. Concurrent single-image requests
are coalesced into the engine's fixed batch by ``serve.MicroBatcher``,
with double-buffered dispatch to the card. A classifier and a detector can
be served side by side from one process, each on its own batcher thread.

Endpoints (body = raw JPEG/PNG bytes):
  POST /v1/classify  -> {"label", "confidence", "probs"}
  POST /v1/detect    -> {"count", "detections": [{"box" (orig px), "conf",
                         "cls", "name"}]}
  GET  /healthz      -> {"ok": true, ...}
  GET  /stats        -> per-batcher request/batch/latency stats

A JPEG body is decoded by the native libjpeg decoder
(``data/native_io.py``: DCT-prescaled decode, the cv2-matching resize and
the crop or letterbox), as in the JAX server; any other body, or a machine
where the library is not built, takes PIL.

Usage:
  python -m rtdm_tpu_torch.cli.serve --engine engines/se-bf16 \
      [--detector engines/v4t-int8] [--port 8000] [--max-wait-ms 2] \
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from rtdm_tpu_torch.models.ernet import CLASS_NAMES


def _decode_image(body: bytes) -> np.ndarray:
    """Image bytes -> RGB HWC uint8 (the PIL path)."""
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.uint8)


def _peek_dims(body: bytes):
    """(w, h) from the header alone (PIL's lazy open, no pixel decode);
    None when PIL cannot read it."""
    from PIL import Image
    try:
        with Image.open(io.BytesIO(body)) as im:
            return im.size
    except Exception:  # noqa: BLE001 — any unreadable body takes PIL's path
        return None


def _native_classify_frame(body: bytes, size: int):
    """JPEG bytes -> the (size, size, 3) uint8 eval frame by the native
    decoder, in ``aider_predict.preprocess``'s geometry: the shorter side
    resized to int(1.14 * size), then the center crop. The aspect-exact
    rect letterbox is a plain resize (at most 1 px of border, inside the
    crop's margin of 9 px or more). None for a body the native path does
    not take, which then goes through PIL."""
    from rtdm_tpu_torch.data import native_io
    if not native_io.available():
        return None
    wh = _peek_dims(body)
    if wh is None:
        return None
    w, h = wh
    target = int(size * 1.14)
    if w <= h:
        nw, nh = target, max(int(round(h * target / w)), target)
    else:
        nh, nw = target, max(int(round(w * target / h)), target)
    res = native_io.decode_jpeg_letterbox_rect(body, nh, nw)
    if res is None:
        return None
    left, top = (nw - size) // 2, (nh - size) // 2
    return np.ascontiguousarray(res[0][top:top + size, left:left + size])


def classify_frame(body: bytes, size: int) -> np.ndarray:
    """Image bytes -> the classifier's (size, size, 3) uint8 eval frame:
    the native frame, else PIL and ``aider_predict.preprocess``."""
    frame = _native_classify_frame(body, size)
    if frame is None:
        from rtdm_tpu_torch.cli.aider_predict import preprocess
        frame = preprocess(_decode_image(body), size)[0]
    return frame


def detect_frame(body: bytes, size: int):
    """Image bytes -> (letterboxed frame, gain, pads, original (h, w)): one
    native decode and letterbox, else PIL and ``letterbox_image``."""
    from rtdm_tpu_torch.data import native_io
    res = native_io.decode_jpeg_letterbox(body, size)
    if res is not None:
        return res
    from rtdm_tpu_torch.data.odder import letterbox_image
    img = _decode_image(body)
    boxed, gain, pads = letterbox_image(img, size)
    return boxed, gain, pads, img.shape[:2]


class _ClassifyService:
    def __init__(self, engine_dir: str, max_wait_ms: float, depth: int,
                 device="cuda"):
        from rtdm_tpu_torch.export.engine import Engine
        from rtdm_tpu_torch.serve.batcher import MicroBatcher
        self.engine = Engine.load(engine_dir, device=device)
        self.size = self.engine.spec.image_size
        # warm before serving: the first call on the card pays the kernels'
        # load and cuDNN's algorithm search, which belong in startup
        self.engine(np.zeros((1, self.size, self.size, 3), np.uint8))
        self.batcher = MicroBatcher(self.engine.dispatch,
                                    self.engine.spec.batch_size,
                                    max_wait_ms=max_wait_ms, depth=depth)

    def __call__(self, body: bytes) -> dict:
        probs = np.asarray(self.batcher(classify_frame(body, self.size)),
                           np.float32)
        idx = int(np.argmax(probs))
        return {"label": CLASS_NAMES[idx] if idx < len(CLASS_NAMES)
                else str(idx),
                "confidence": float(probs[idx]),
                "probs": {CLASS_NAMES[i]: float(p)
                          for i, p in enumerate(probs)
                          if i < len(CLASS_NAMES)}}


class _DetectService:
    def __init__(self, engine_dir: str, max_wait_ms: float, depth: int,
                 names: Optional[list] = None, device="cuda"):
        from rtdm_tpu_torch.export.detector import load_detector
        from rtdm_tpu_torch.serve.batcher import MicroBatcher
        self.det = load_detector(engine_dir, device=device)
        self.size = self.det.spec.img_size
        self.names = names or ["person", "vehicle"]
        self.det.warmup()  # at startup, never in a timed request

        @torch.inference_mode()
        def dispatch(frames: np.ndarray):
            # submit zero-pads to the engine's batch; rows align with frames
            det, count, _ = self.det.submit(frames)
            return det, count

        self.batcher = MicroBatcher(dispatch, self.det.batch_size,
                                    max_wait_ms=max_wait_ms, depth=depth)

    def __call__(self, body: bytes) -> dict:
        boxed, gain, pads, orig_hw = detect_frame(body, self.size)
        det, count = self.batcher(boxed)
        return detections_to_json(np.asarray(det, np.float32), int(count),
                                  gain, pads, orig_hw, self.names)


def detections_to_json(det: np.ndarray, count: int, gain: float,
                       pads: tuple, orig_hw: tuple, names: list) -> dict:
    """(max_det, 6)+count -> JSON dict with boxes un-letterboxed into
    original pixels (scale_coords semantics, using the exact gain/pad the
    letterbox applied)."""
    (oh, ow), (pad_w, pad_h) = orig_hw, pads
    out = []
    for i in range(count):
        x1, y1, x2, y2, conf, cls = det[i, :6]
        box = [(x1 - pad_w) / gain, (y1 - pad_h) / gain,
               (x2 - pad_w) / gain, (y2 - pad_h) / gain]
        box = [float(np.clip(v, 0, [ow, oh, ow, oh][j]))
               for j, v in enumerate(box)]
        c = int(cls)
        out.append({"box": box, "conf": float(conf), "cls": c,
                    "name": names[c] if c < len(names) else str(c)})
    return {"count": count, "detections": out}


def make_server(port: int, classify: Optional[_ClassifyService],
                detect: Optional[_DetectService],
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True,
                                 "classify": classify is not None,
                                 "detect": detect is not None})
            elif self.path == "/stats":
                stats = {}
                if classify:
                    stats["classify"] = classify.batcher.stats().as_dict()
                if detect:
                    stats["detect"] = detect.batcher.stats().as_dict()
                self._json(200, stats)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            svc = {"/v1/classify": classify, "/v1/detect": detect}.get(
                self.path)
            if svc is None:
                self._json(404, {"error": f"no service at {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                result = svc(self.rfile.read(n))
                self._json(200, result)
            except TimeoutError as e:
                # the batcher's future timed out: overloaded or still
                # warming; retryable, so 503 not 400
                self._json(503, {"error": f"{type(e).__name__}: {e}",
                                 "retryable": True})
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # the stdlib's listen backlog of 5 resets connections when ~50
        # clients wait behind a dispatch; the batcher already bounds the
        # admitted work, so a deep accept queue is safe
        request_queue_size = 128
        daemon_threads = True

    return Server((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", help="classifier engine dir (Engine.save)")
    ap.add_argument("--detector", help="detector engine dir (save_detector)")
    ap.add_argument("--names", help="comma-separated detector class names")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch deadline after the first request")
    ap.add_argument("--depth", type=int, default=2,
                    help="in-flight batches (double buffering)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not args.engine and not args.detector:
        ap.error("need --engine and/or --detector")
    classify = (_ClassifyService(args.engine, args.max_wait_ms, args.depth,
                                 args.device) if args.engine else None)
    names = args.names.split(",") if args.names else None
    detect = (_DetectService(args.detector, args.max_wait_ms, args.depth,
                             names, args.device) if args.detector else None)
    server = make_server(args.port, classify, detect, args.host)
    print(f"rtdm-serve listening on :{server.server_address[1]} "
          f"(classify={bool(classify)}, detect={bool(detect)}, "
          f"device={args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if classify:
            classify.batcher.close()
        if detect:
            detect.batcher.close()


if __name__ == "__main__":
    main()
