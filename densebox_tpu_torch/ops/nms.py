"""Greedy IoU-NMS over fixed-capacity candidate sets, batched.

Port of ``densebox_tpu/ops/nms.py`` (``nms``, ``nms_dispatch``) and of the
wrapper ``densebox_tpu/ops/pallas/nms.py:nms_pallas``: a stable score sort,
the greedy keep mask, then the top ``max_out`` survivors. The keep mask is
``ops.kernels.nms.greedy_keep``, which the tensor's device decides: the
CUDA kernel on the card, its plain version on the CPU. The JAX package's
``nms_backend`` policy is a TPU measurement; the port reads no backend.
"""

from __future__ import annotations

from typing import Tuple

import torch

from densebox_tpu_torch.ops.decode import topk_stable
from densebox_tpu_torch.ops.kernels.nms import (  # noqa: F401
    box_area,
    greedy_keep,
    iou_matrix,
)


def nms(
    boxes: torch.Tensor,    # (B, K, 4) xyxy float32
    scores: torch.Tensor,   # (B, K)
    valid: torch.Tensor,    # (B, K) bool
    *,
    iou_thresh: float,
    max_out: int,
    return_idx: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Greedy NMS per image.

    Returns (boxes (B, max_out, 4), scores (B, max_out), valid (B, max_out))
    sorted by score descending, plus with ``return_idx`` each slot's index
    into the ORIGINAL candidate axis. Ties keep the lower index first, as
    ``jnp.argsort`` and ``lax.top_k`` do; slots past K (``max_out > K``) hold
    zero boxes, score -inf, invalid, index 0.
    """
    b, k = scores.shape
    neg_inf = float("-inf")
    order = torch.sort(scores.masked_fill(~valid, neg_inf), dim=1,
                       descending=True, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    scores = torch.gather(scores, 1, order)
    valid = torch.gather(valid, 1, order)

    keep = greedy_keep(boxes, valid, iou_thresh)

    out_scores, sel = topk_stable(scores.masked_fill(~keep, neg_inf),
                                  min(max_out, k))
    n = sel.shape[1]
    out_boxes = torch.gather(boxes, 1, sel[..., None].expand(b, n, 4))
    out_valid = torch.gather(keep, 1, sel)
    out_idx = torch.gather(order, 1, sel)
    if max_out > k:
        pad = max_out - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(b, pad, 4)], 1)
        out_scores = torch.cat(
            [out_scores, out_scores.new_full((b, pad), float("-inf"))], 1)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(b, pad)], 1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros(b, pad)], 1)
    if return_idx:
        return out_boxes, out_scores, out_valid, out_idx
    return out_boxes, out_scores, out_valid
