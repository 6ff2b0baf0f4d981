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
device without blocking. An HTTP front end needs only ``submit`` and
``stats`` of this server.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.infer.detector import make_detect_fn


class DetectServer:
    """Request-coalescing wrapper around the port's detect function for a
    ``DenseBox`` or the int8 ``QuantDenseBox``. The model is moved to
    ``device``: the card when none is given (raising without one), the CPU
    only on ``device="cpu"``."""

    def __init__(self, model, infer_cfg, label_cfg,
                 canvas_hw: Tuple[int, int] = (480, 640),
                 max_batch: int = 8, batch_window_ms: float = 15.0,
                 device=None):
        self.device = resolve_device(device)
        model.to(self.device)
        self.canvas_hw = canvas_hw
        self.max_batch = max_batch
        self.window_s = batch_window_ms / 1e3
        # observability: device_calls vs requests is the coalescing ratio
        self.stats = {"requests": 0, "device_calls": 0}
        self._detect = make_detect_fn(model, infer_cfg, label_cfg)
        hc, wc = canvas_hw
        self._host = torch.zeros((max_batch, hc, wc, 3), dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")
        # warm-up: the first call builds the kernels and sets up cuDNN
        self._detect(torch.zeros((max_batch, hc, wc, 3), device=self.device))
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- request path ------------------------------------------------------

    def _letterbox(self, img: np.ndarray) -> Tuple[np.ndarray, float]:
        hc, wc = self.canvas_hw
        h, w = img.shape[:2]
        f = min(1.0, hc / h, wc / w)
        if f < 1.0:
            try:
                import cv2
            except ImportError as e:
                raise ImportError(
                    f"a {h}x{w} image is larger than the {hc}x{wc} canvas; "
                    "downscaling it needs OpenCV (cv2), which is not "
                    "installed — send images no larger than the canvas"
                ) from e
            img = cv2.resize(img, (int(w * f), int(h * f)),
                             interpolation=cv2.INTER_AREA)
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
