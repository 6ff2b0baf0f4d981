"""Batched inference serving (port of ``densebox_tpu/serve.py:DetectServer``).

Same contract as the JAX server:

  * requests are letterboxed onto a fixed ``(max_batch, H, W, 3)`` canvas
    (downscale-to-fit, top-left placement), so every device call has one
    shape; short batches pad with zero images whose results are dropped;
  * the first queued request opens a ``batch_window_ms`` window, and every
    request arriving inside it rides the same device call;
  * results come back in each request's own image coordinates (boxes,
    scores and, for a landmark model, lm_points and lm_valid);
  * ``stats`` counts requests and device calls.

The batch is assembled in one pinned host buffer and copied to the model's
device without blocking.

``DetectServer.from_exported`` serves an artifact of ``export.py`` (``cli
serve --artifact``). ``make_http_server`` puts the JAX package's stdlib HTTP
front end before it (``python -m densebox_tpu_torch.cli serve``): POST
/detect with an encoded image body (decoded by ``data/imageio.py``: PNG
without cv2) -> JSON detections; GET /healthz -> status, ``stats`` and
model info.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densebox_tpu_torch.data.imageio import imdecode, resize_area
from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.infer.detector import make_detect_fn

# /detect body cap: an encoded image tops out in the low MBs; a larger body
# is a client bug or abuse and is refused with 413 before it is read
MAX_BODY_BYTES = 32 * 1024 * 1024


class DetectServer:
    """Request-coalescing wrapper around the port's detect function for a
    ``DenseBox`` or the int8 ``QuantDenseBox``, or (``from_exported``)
    around an exported artifact. The model is moved to ``device``: the card
    when none is given (raising without one), the CPU only on
    ``device="cpu"``. With ``warmup`` (the default, as in the JAX server)
    the constructor runs one device call on a zero canvas batch before it
    returns, so that the first request pays for no kernel build and no
    cuDNN algorithm search."""

    def __init__(self, model, infer_cfg, label_cfg,
                 canvas_hw: Tuple[int, int] = (480, 640),
                 max_batch: int = 8, batch_window_ms: float = 15.0,
                 warmup: bool = True, device=None):
        device = resolve_device(device)
        model.to(device)
        self._init(make_detect_fn(model, infer_cfg, label_cfg), canvas_hw,
                   max_batch, batch_window_ms, warmup, device)

    @classmethod
    def from_exported(cls, path: str, max_batch: Optional[int] = None,
                      batch_window_ms: float = 15.0, warmup: bool = True,
                      device=None) -> "DetectServer":
        """Serve a ``cli export`` artifact (``export.py``) on ``device`` (the
        card when none is given): no checkpoint, no model code. The
        artifact's fixed (batch, H, W) becomes the serving (max_batch,
        canvas); ``max_batch`` may only restate it. ``meta`` holds the
        artifact's metadata."""
        from densebox_tpu_torch.export import load_exported

        device = resolve_device(device)
        call, meta = load_exported(path, device)
        if max_batch is not None and max_batch != meta["batch"]:
            raise ValueError(
                f"artifact was exported with batch {meta['batch']}; "
                f"max_batch {max_batch} cannot differ (the program's shapes "
                "are fixed): re-export with --batch")
        self = cls.__new__(cls)
        self._init(call, tuple(meta["canvas"]), meta["batch"],
                   batch_window_ms, warmup, device)
        self.meta = meta
        return self

    def _init(self, detect_fn, canvas_hw, max_batch, batch_window_ms,
              warmup, device) -> None:
        self.device = device
        self.canvas_hw = canvas_hw
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1e3
        # observability: device_calls vs requests is the coalescing ratio
        self.stats = {"requests": 0, "device_calls": 0}
        self._detect = detect_fn
        hc, wc = canvas_hw
        self._host = torch.zeros((max_batch, hc, wc, 3), dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")
        if warmup:
            self._detect(torch.zeros((max_batch, hc, wc, 3),
                                     device=self.device))
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- request path ------------------------------------------------------

    def _letterbox(self, img: np.ndarray) -> Tuple[np.ndarray, float]:
        hc, wc = self.canvas_hw
        h, w = img.shape[:2]
        f = min(1.0, hc / h, wc / w)
        if f < 1.0:           # needs cv2, and raises ImportError without it
            img = resize_area(img, (int(w * f), int(h * f)))
            h, w = img.shape[:2]
        canvas = np.zeros((hc, wc, 3), np.float32)
        canvas[:h, :w] = img
        return canvas, f

    def submit(self, image_rgb_f32: np.ndarray,
               timeout: Optional[float] = 60.0) -> Dict[str, np.ndarray]:
        """Blocking detect on one (H, W, 3) float32 RGB image in [0, 1].
        Returns numpy detections in the image's own coordinates."""
        if self._stop.is_set():
            raise RuntimeError("server closed")
        canvas, f = self._letterbox(image_rgb_f32)
        done = threading.Event()
        slot: Dict[str, np.ndarray] = {}
        self._q.put((canvas, f, done, slot))
        if self._stop.is_set() and not done.wait(0.05):
            # raced with close(): the item may sit behind the close-side
            # drain with no worker left to consume it
            raise RuntimeError("server closed")
        if not done.wait(timeout):
            raise TimeoutError("detect request timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._worker.join(5.0)
        # fail pending requests fast instead of leaving their submit()
        # callers to ride out the full request timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _, _, done, slot = item
                slot["error"] = "server closed"
                done.set()

    # -- device loop -------------------------------------------------------

    def _collect(self) -> List[tuple]:
        first = self._q.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                item = self._q.get(timeout=left)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        host = self._host.numpy()
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                # the previous call's results were copied back before this
                # point, so its host-to-device copy of the buffer is done
                for i, (canvas, _, _, _) in enumerate(batch):
                    host[i] = canvas
                host[len(batch):] = 0.0
                self.stats["requests"] += len(batch)
                self.stats["device_calls"] += 1
                out = self._detect(self._host.to(self.device,
                                                 non_blocking=True))
                out = {k: v.cpu().numpy() for k, v in out.items()}
                for i, (_, f, done, slot) in enumerate(batch):
                    v = out["valid"][i]
                    slot["boxes"] = out["boxes"][i][v] / f
                    slot["scores"] = out["scores"][i][v]
                    if "lm_points" in out:
                        slot["lm_points"] = out["lm_points"][i][v] / f
                        slot["lm_valid"] = out["lm_valid"][i][v]
                    done.set()
            except Exception as e:  # noqa: BLE001 - relayed per request
                for _, _, done, slot in batch:
                    slot["error"] = f"{type(e).__name__}: {e}"
                    done.set()


def make_http_server(server: DetectServer, host: str, port: int,
                     info: Optional[dict] = None):
    """The stdlib HTTP front end over ``server``, bound but not serving (port
    0 picks a free port: read it from ``.server_address``). POST /detect
    (an encoded image body) -> {"n", "boxes", "scores"} and, for a landmark
    model, "lm_points" and "lm_valid", in the image's own coordinates (boxes
    and points rounded to 2 decimals, scores to 4); 400 for a body that does
    not decode (or, without cv2, one that only cv2 could decode or
    downscale), 413 over ``MAX_BODY_BYTES``, 500 when the server fails.
    GET /healthz -> {"status": "ok", **stats, **info}."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; serving logs are the caller's
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
                self._json(200, {"status": "ok", **server.stats,
                                 **(info or {})})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            if n > MAX_BODY_BYTES:
                self._json(413, {"error": "request body too large "
                                          f"(max {MAX_BODY_BYTES} bytes)"})
                return
            raw = self.rfile.read(n)
            try:
                img = imdecode(raw)
                if img is None:
                    self._json(400, {"error": "could not decode image"})
                    return
                dets = server.submit(img.astype(np.float32) / 255.0)
            except ImportError as e:     # a format or size only cv2 handles
                self._json(400, {"error": str(e)})
                return
            except (TimeoutError, RuntimeError) as e:
                self._json(500, {"error": str(e)})
                return
            resp = {"n": int(len(dets["boxes"])),
                    "boxes": np.round(dets["boxes"], 2).tolist(),
                    "scores": np.round(dets["scores"], 4).tolist()}
            if "lm_points" in dets:
                resp["lm_points"] = np.round(dets["lm_points"], 2).tolist()
                resp["lm_valid"] = dets["lm_valid"].tolist()
            self._json(200, resp)

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(httpd, stop_event: Optional[threading.Event] = None,
                  poll_s: float = 0.25) -> None:
    """Serve until ``stop_event`` is set (or forever); the socket is closed
    on the way out, by an exception too."""
    httpd.timeout = poll_s
    try:
        while stop_event is None or not stop_event.is_set():
            httpd.handle_request()
    finally:
        httpd.server_close()
