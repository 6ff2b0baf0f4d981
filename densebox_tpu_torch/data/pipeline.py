"""Host input pipeline: decode and canvas-pad full images, prefetch to the
device (port of ``densebox_tpu/data/pipeline.py``).

The host only reads and pads images; patch sampling, augmentation and GT
rasterization run on the device (``data/patches.py``, ``ops/labels.py``). A
producer thread builds each batch as host tensors, pinned when the batch
goes to the card; the consuming thread copies them to the device without
blocking as it hands the batch out, on its current stream, so the step that
reads the batch is ordered after the copy.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from densebox_tpu_torch.data.imageio import imread, resize_area
from densebox_tpu_torch.data.kitti import Sample
from densebox_tpu_torch.device import resolve_device

BACKENDS = ("auto", "native", "python")


def _imread(path: str) -> np.ndarray:
    img = imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def resolve_backend(backend: str = "auto") -> str:
    """'native' or 'python'. 'auto' takes the native core where it builds
    and the machine has more than one core (its value is its thread pool),
    as the JAX package does."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        from densebox_tpu_torch.native import native_available

        backend = ("native" if (os.cpu_count() or 1) > 1
                   and native_available() else "python")
    return backend


def canvas_batch(samples: Sequence[Sample], canvas_hw: Tuple[int, int],
                 max_boxes: int, num_landmarks: int = 0,
                 backend: str = "auto", image_dtype: str = "float32",
                 pin_memory: bool = False) -> dict:
    """Load and zero-pad images onto a fixed canvas; pad box tensors.
    Images larger than the canvas are downscaled to fit (boxes and
    landmarks follow; this needs cv2). With ``num_landmarks``, emits
    ``landmarks`` / ``lm_valid`` lanes (invisible keypoints, coordinates
    < 0 in the annotation, get lm_valid False).

    Returns CPU tensors (pinned with ``pin_memory``): ``image`` (B, H, W, 3)
    float32, or bfloat16 rounded to nearest even with
    ``image_dtype="bfloat16"``; ``boxes`` (B, K, 4); ``box_valid`` (B, K);
    ``scale`` (B,), the image -> canvas factor that eval maps predictions
    back with. ``backend``: 'native' (the C++ thread pool, ``native/``),
    'python' (one image at a time through ``data/imageio.py``) or 'auto'
    (``resolve_backend``); their pixels are equal."""
    hc, wc = canvas_hw
    b = len(samples)
    boxes = np.zeros((b, max_boxes, 4), np.float32)
    valid = np.zeros((b, max_boxes), bool)
    lms = np.zeros((b, max_boxes, num_landmarks, 2), np.float32)
    lm_valid = np.zeros((b, max_boxes, num_landmarks), bool)
    image_t = torch.zeros((b, hc, wc, 3), dtype=torch.float32,
                          pin_memory=pin_memory and image_dtype == "float32")
    images = image_t.numpy()

    if resolve_backend(backend) == "native":
        from densebox_tpu_torch.native import load_canvas_native

        _, scales, _ = load_canvas_native([s.image_path for s in samples],
                                          canvas_hw, images=images)
    else:
        scales = np.ones((b,), np.float32)
        for i, s in enumerate(samples):
            img = _imread(s.image_path).astype(np.float32) / 255.0
            h, w = img.shape[:2]
            f = min(1.0, hc / h, wc / w)
            if f < 1.0:
                img = resize_area(img, (int(w * f), int(h * f)))
                h, w = img.shape[:2]
            images[i, :h, :w] = img
            scales[i] = f

    for i, s in enumerate(samples):
        f = float(scales[i])
        n = min(len(s.boxes), max_boxes)
        if n:
            boxes[i, :n] = s.boxes[:n] * f
            valid[i, :n] = True
            if num_landmarks and s.landmarks is not None and len(s.landmarks):
                pts = s.landmarks[:n, :num_landmarks]
                vis = (pts >= 0).all(axis=-1)
                lms[i, :n, :pts.shape[1]] = np.where(
                    vis[..., None], pts * f, 0.0)
                lm_valid[i, :n, :pts.shape[1]] = vis
    if image_dtype == "bfloat16":
        # TrainCfg.canvas_dtype: 8-bit image data goes to the device as bf16
        image_t = torch.empty(image_t.shape, dtype=torch.bfloat16,
                              pin_memory=pin_memory).copy_(image_t)
    out = {"image": image_t, "boxes": boxes, "box_valid": valid,
           "scale": scales}
    if num_landmarks:
        out["landmarks"] = lms
        out["lm_valid"] = lm_valid
    for k, v in out.items():
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(v)
            out[k] = v.pin_memory() if pin_memory else v
    return out


class PrefetchLoader:
    """Epoch-shuffling batch iterator with a background producer thread and
    ``prefetch`` batches queued ahead of the consumer, on ``device`` (the
    card when none is given; raises without one).

    The host backend (``resolve_backend("auto")``) is chosen once, here,
    and kept in ``self.backend``. ``stats`` counts the batches handed out
    (``batches``), how many of them the consumer had to wait for because
    none was queued (``waited``) and the seconds it waited (``wait_s``)."""

    def __init__(self, samples: List[Sample], batch_size: int,
                 canvas_hw: Tuple[int, int], max_boxes: int,
                 seed: int = 0, prefetch: int = 2,
                 num_landmarks: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 image_dtype: str = "float32", device=None):
        """``batch_size`` is the GLOBAL batch; with ``num_shards`` > 1 (one
        shard per process, seeded identically) each process yields its
        ``batch_size / num_shards`` slice of every global batch: the slices
        across processes partition exactly the samples a single-process
        loader would draw."""
        if batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_shards} shards")
        self.samples = samples
        self.batch_size = batch_size
        self.canvas_hw = canvas_hw
        self.max_boxes = max_boxes
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.num_landmarks = num_landmarks
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.image_dtype = image_dtype
        self.device = resolve_device(device)
        self.backend = resolve_backend()
        self.stats = {"batches": 0, "waited": 0, "wait_s": 0.0}

    def _produce_batches(self) -> Iterator[dict]:
        local = self.batch_size // self.num_shards
        while True:
            order = self.rng.permutation(len(self.samples))
            for i in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
                lo = i + self.shard_index * local
                yield canvas_batch(
                    [self.samples[j] for j in order[lo:lo + local]],
                    self.canvas_hw, self.max_boxes, self.num_landmarks,
                    backend=self.backend, image_dtype=self.image_dtype,
                    pin_memory=self.device.type == "cuda")

    def _producer(self, q: "queue.Queue", stop: threading.Event) -> None:
        # A producer failure (a corrupt or missing image raising in
        # canvas_batch) travels through the queue and re-raises in the
        # consumer: a dead producer must not leave it blocked on q.get().
        try:
            for batch in self._produce_batches():
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - relayed, not swallowed
            while not stop.is_set():
                try:
                    q.put(_ProducerFailed(e), timeout=0.5)
                    return
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._producer, args=(q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    t0 = time.perf_counter()
                    item = q.get()
                    self.stats["waited"] += 1
                    self.stats["wait_s"] += time.perf_counter() - t0
                if isinstance(item, _ProducerFailed):
                    raise RuntimeError(
                        "PrefetchLoader producer thread failed"
                    ) from item.error
                batch = {k: v.to(self.device, non_blocking=True)
                         for k, v in item.items()}
                self.stats["batches"] += 1
                # `item` (the pinned host tensors) stays referenced until
                # the consumer asks for the next batch, by which time the
                # step reading `batch` has been enqueued behind the copy
                yield batch
        finally:
            stop.set()


class _ProducerFailed:
    """Queue sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error
