"""Greedy-NMS keep mask: the CUDA kernel's wrapper and its plain version.

``greedy_keep`` replaces ``densebox_tpu/ops/pallas/nms.py:greedy_keep_pallas``
(kernel ``_nms_kernel``), batched over images. It is the custom operator
``densebox::greedy_keep``: on a CUDA tensor it launches ``csrc/nms.cu``
(built on first use) or raises; on a CPU tensor it runs
``greedy_keep_reference``, the plain PyTorch version the kernel is held
against; under ``torch.export`` it is one opaque node whose fake rule gives
the output's shape, so an exported program dispatches by device when it
runs. The source comment of ``csrc/nms.cu`` gives the kernel's design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from densebox_tpu_torch.ops.kernels import build

MAX_K = 1024

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp_min(0)
            * (boxes[..., 3] - boxes[..., 1]).clamp_min(0))


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes -> (..., N, M),
    with the operations and order of ``densebox_tpu.ops.nms.iou_matrix``."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thresh: float) -> torch.Tensor:
    """Plain version: keep (B, K) bool for score-descending-sorted boxes
    (B, K, 4) and valid (B, K). ``keep = valid``; for i ascending, a kept i
    suppresses every j > i with IoU > iou_thresh — the exact sequential
    greedy algorithm, as ``densebox_tpu.ops.nms.nms`` runs it."""
    k = boxes.shape[1]
    ar = torch.arange(k, device=boxes.device)
    hits = (iou_matrix(boxes, boxes) > iou_thresh) & (ar[None, :] > ar[:, None])
    keep = valid.clone()
    for i in range(k):
        keep &= ~(hits[:, i] & keep[:, i:i + 1])
    return keep


def launch_shape(b: int, k: int) -> tuple[int, int]:
    """(cluster, threads) of csrc/nms.cu's launch: CTAs an image, doubled
    up to 8 while each takes at least 64 boxes and the grid stays within
    two CTAs per SM of the H100 (2 x 132); 1024 threads a CTA where the
    grid fits the card once (one CTA an SM: more warps for the IoU tests),
    else 512 (two an SM)."""
    words = -(-k // 64)
    c = 1
    while c < 8 and 2 * c <= words and 2 * c * b <= 264:
        c *= 2
    return c, 1024 if b * c <= 132 else 512


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_nms_keep`` of csrc/nms.cu, built and loaded on first use."""
    fn = build.load("nms").densebox_nms_keep
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _set_up(device_index: int) -> None:
    """Raise the kernel's shared-memory limit on one device, once, so that a
    call is one launch and no other host call."""
    setup = build.load("nms").densebox_nms_setup
    setup.restype = ctypes.c_int
    with torch.cuda.device(device_index):
        rc = setup()
    if rc != 0:
        raise RuntimeError(f"greedy_keep: setting the NMS kernel's shared "
                           f"memory failed with CUDA error {rc}")


@torch.library.custom_op(
    "densebox::greedy_keep", mutates_args=(), device_types="cpu",
    schema="(Tensor boxes, Tensor valid, float iou_thresh) -> Tensor")
def _greedy_keep_op(boxes, valid, iou_thresh):
    return greedy_keep_reference(boxes, valid, iou_thresh)


@_greedy_keep_op.register_fake
def _(boxes, valid, iou_thresh):
    return torch.empty_like(valid)


@_greedy_keep_op.register_kernel("cuda")
def _greedy_keep_cuda(boxes, valid, iou_thresh):
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"greedy_keep: want float32 boxes and bool valid, "
                        f"got {boxes.dtype} and {valid.dtype}")
    if (boxes.dim() != 3 or boxes.shape[2] != 4
            or tuple(valid.shape) != tuple(boxes.shape[:2])):
        raise ValueError(f"greedy_keep: want boxes (B, K, 4) and valid "
                         f"(B, K), got {tuple(boxes.shape)} and "
                         f"{tuple(valid.shape)}")
    if valid.device != boxes.device:
        raise ValueError("greedy_keep: boxes and valid on different devices")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_keep: boxes and valid must be contiguous")
    b, k = valid.shape
    if not 1 <= k <= MAX_K or not 1 <= b <= 65535:
        raise ValueError(f"greedy_keep: want 1 <= K <= {MAX_K} and "
                         f"1 <= B <= 65535, got B={b} K={k}")
    _set_up(boxes.device.index)
    with torch.cuda.device(boxes.device):
        keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
        rc = _launcher()(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            *launch_shape(b, k), float(iou_thresh),
            torch.cuda.current_stream(boxes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_keep: NMS kernel launch failed with "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return keep


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thresh: float) -> torch.Tensor:
    """Keep mask (B, K) bool for score-descending-sorted candidates, through
    ``densebox::greedy_keep``.

    CPU tensors take ``greedy_keep_reference``. CUDA tensors launch the
    kernel (boxes float32 (B, K, 4), valid bool (B, K), both contiguous,
    1 <= K <= 1024), counting the launch in ``launches``; anything else
    raises, and so does a refused launch."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_keep: no kernel for device {boxes.device}")
    return _greedy_keep_op(boxes, valid, float(iou_thresh))
