"""Heatmap -> box decode, batched (port of ``densebox_tpu/ops/decode.py``).

Fixed-shape top-K over each flattened score map: always K candidates per
image, each with a validity bit (score > threshold), so NMS downstream works
on fixed shapes and masks.

Coordinates: map pixel (iy, ix) <-> scaled-image point (ix * stride,
iy * stride); loc channels are (d_left, d_top, d_right, d_bottom) border
distances in map units divided by ``loc_norm``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` for a Python number ``s``, rounded once on every device as
    on the CPU: CUDA divides a tensor by a host scalar as a product with the
    scalar's reciprocal, which can differ in the last bit."""
    if x.device.type != "cpu":
        s = torch.full((), s, dtype=x.dtype, device=x.device)
    return x / s


def rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """``s / x`` for a Python number ``s``, rounded once (``s / x`` on a
    tensor is ``x.reciprocal() * s``, two roundings)."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among ties — the order
    ``lax.top_k`` gives. A stable descending sort sliced to k: the tie
    order of ``torch.topk`` on CUDA is unspecified."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_topk(
    score_map: torch.Tensor,   # (B, H, W) or (B, H, W, 1) raw scores
    loc_map: torch.Tensor,     # (B, H, W, 4) normalized border distances
    *,
    stride: int,
    loc_norm: float,
    topk: int,
    score_thresh: float,
    scale_x: float = 1.0,      # scaled-image -> original-image factor (x)
    scale_y: float = 1.0,
    approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extract each image's top-K scoring pixels and decode their boxes.

    Returns (boxes (B, K, 4) xyxy in original-image coords, scores (B, K),
    valid (B, K) bool). Invalid pad slots (K > H*W) hold score -inf and
    zero boxes. ``approx`` (``lax.approx_max_k`` in the JAX package, a TPU
    operation) is accepted and ignored: the exact top-k is computed, which
    meets its recall contract.
    """
    del approx
    b, h, w = score_map.shape[:3]
    k = min(topk, h * w)
    scores, idx = topk_stable(score_map.reshape(b, h * w), k)
    iy = torch.div(idx, w, rounding_mode="floor").float()
    ix = (idx % w).float()

    d = torch.gather(loc_map.reshape(b, h * w, 4), 1,
                     idx[..., None].expand(b, k, 4)) * loc_norm
    x1 = div((ix - d[..., 0]) * stride, scale_x)
    y1 = div((iy - d[..., 1]) * stride, scale_y)
    x2 = div((ix + d[..., 2]) * stride, scale_x)
    y2 = div((iy + d[..., 3]) * stride, scale_y)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    valid = scores > score_thresh
    if k < topk:  # pad up to the fixed capacity
        pad = topk - k
        boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 4)], dim=1)
        scores = torch.cat(
            [scores, scores.new_full((b, pad), float("-inf"))], dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
    return boxes, scores, valid
