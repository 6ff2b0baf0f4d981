"""On-device dense GT label-map rasterizer (port of
``densebox_tpu/ops/labels.py``; paper §3.1).

Geometry, all in map units (input px / stride):
  * positive region: disc of radius rc = rc_ratio * box height around the
    box centre, for boxes whose height lies in the scale band;
  * regression target at a positive pixel p of box b:
    (p_x - x1, p_y - y1, x2 - p_x, y2 - p_y) / loc_norm; where discs overlap
    the pixel goes to the box with the nearest centre (the lowest index
    among equals);
  * gray zone (ignore): within rc + rnear of the centre of any valid box
    (in band or not) and not positive;
  * landmark channels: discs of radius 1 at each visible landmark of an
    in-band box.

``rasterize`` keeps the JAX function's name and output dict. The packing of
boxes into kernel rows is plain torch; the maps come from the two kernels
of ``ops/kernels/labels.py`` (CUDA on the card, their plain versions on the
CPU), already in NHWC. With landmarks both kernels' work goes out as one
launch (``rasterize_maps``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.ops.kernels.labels import (  # noqa: F401
    LM_RADIUS,
    pack_boxes,
    pack_landmarks,
    rasterize_boxes,
    rasterize_landmarks,
    rasterize_maps,
)


def rasterize(
    boxes: torch.Tensor,                       # (B, K, 4) xyxy, patch px
    box_valid: torch.Tensor,                   # (B, K) bool
    cfg: LabelCfg,
    landmarks: Optional[torch.Tensor] = None,  # (B, K, L, 2) xy patch px
    lm_valid: Optional[torch.Tensor] = None,   # (B, K, L) bool
) -> Dict[str, torch.Tensor]:
    """Rasterize padded per-patch boxes into dense GT maps, float32 NHWC:

      score:    (B, M, M, 1) in {0, 1}
      loc:      (B, M, M, 4) normalized border distances (0 off-positive)
      loc_mask: (B, M, M, 1) pixels carrying regression targets (= score)
      ignore:   (B, M, M, 1) gray-zone pixels (excluded from the cls loss)
      lm:       (B, M, M, L) landmark discs            [if landmarks given]
    """
    if boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"rasterize: want boxes (B, K, 4), got "
                         f"{tuple(boxes.shape)}")
    if box_valid.shape != boxes.shape[:2] or box_valid.dtype != torch.bool:
        raise ValueError(f"rasterize: want bool box_valid "
                         f"{tuple(boxes.shape[:2])}, got {box_valid.dtype} "
                         f"{tuple(box_valid.shape)}")
    m = cfg.map_size
    rows, inv_norm = pack_boxes(boxes, box_valid, cfg), 1.0 / cfg.loc_norm
    if landmarks is None:
        score, loc, ignore = rasterize_boxes(rows, m, inv_norm)
    else:
        if (landmarks.dim() != 4 or landmarks.shape[3] != 2
                or landmarks.shape[:2] != boxes.shape[:2]):
            raise ValueError(f"rasterize: want landmarks (B, K, L, 2) for "
                             f"boxes {tuple(boxes.shape)}, got "
                             f"{tuple(landmarks.shape)}")
        if lm_valid is None:
            lm_valid = torch.ones(landmarks.shape[:3], dtype=torch.bool,
                                  device=landmarks.device)
        elif lm_valid.shape != landmarks.shape[:3]:
            raise ValueError(f"rasterize: want lm_valid "
                             f"{tuple(landmarks.shape[:3])}, got "
                             f"{tuple(lm_valid.shape)}")
        lm_rows = pack_landmarks(boxes, box_valid, landmarks, lm_valid, cfg)
        score, loc, ignore, lm = rasterize_maps(rows, lm_rows, m, inv_norm,
                                                landmarks.shape[2])
    out = {"score": score, "loc": loc, "loc_mask": score, "ignore": ignore}
    if landmarks is not None:
        out["lm"] = lm
    return out
