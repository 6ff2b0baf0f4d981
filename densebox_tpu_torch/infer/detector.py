"""Image-pyramid detection (port of ``densebox_tpu/infer/detector.py``).

Per scale: linear resize (``infer.resize``), forward, fixed-K top-k decode;
then the cross-scale concat, clip to the image, the ``pre_nms_topk`` cap and
one greedy NMS per image. Shapes are fixed as in the JAX program: every
image yields ``max_dets`` slots with a validity bit.

Det-only: landmark decode (and the window-gather kernel it needs) is a later
slice of the port, so a model with landmarks is refused rather than served
without them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from densebox_tpu.config import InferCfg, LabelCfg
from densebox_tpu_torch.infer.resize import resize_linear
from densebox_tpu_torch.ops.decode import decode_topk, topk_stable
from densebox_tpu_torch.ops.nms import nms


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pyramid_shapes(h: int, w: int, scales, multiple: int = 8
                   ) -> List[Tuple[int, int, float, float]]:
    """Static per-scale resize targets (hs, ws, hs/h, ws/w): scaled dims
    rounded up to the model's divisibility constraint, with the actual
    per-axis factors so decode maps back to exact original coordinates."""
    out = []
    for s in scales:
        hs = max(multiple, _round_up(int(round(h * s)), multiple))
        ws = max(multiple, _round_up(int(round(w * s)), multiple))
        out.append((hs, ws, hs / h, ws / w))
    return out


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] along axis 1 for (B, K[, ...]) x and (B, N) idx."""
    if x.dim() == 3:
        idx = idx[..., None].expand(*idx.shape, x.shape[2])
    return torch.gather(x, 1, idx)


def candidates(model, images: torch.Tensor, infer_cfg: InferCfg,
               label_cfg: LabelCfg
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The NMS input of ``detect_batch``: per-scale top-k candidates,
    concatenated across scales, clipped to the image and capped at
    ``pre_nms_topk``. Returns (boxes (B, K, 4), scores (B, K), valid (B, K))."""
    if model.cfg.num_landmarks:
        raise NotImplementedError(
            "landmark decode is not ported yet (ROADMAP.md, Queue 1 #6: "
            "landmarks and refine, with the window-gather kernel); this "
            "detector serves det-only models")
    b, h, w, _ = images.shape
    stride = label_cfg.stride
    all_boxes, all_scores, all_valid = [], [], []
    for hs, ws, sy, sx in pyramid_shapes(h, w, infer_cfg.scales):
        imgs = images if (hs, ws) == (h, w) else resize_linear(images, (hs, ws))
        out = model(imgs)
        boxes, scores, valid = decode_topk(
            out["score"], out["loc"], stride=stride,
            loc_norm=label_cfg.loc_norm, topk=infer_cfg.topk_per_scale,
            score_thresh=infer_cfg.score_thresh, scale_x=sx, scale_y=sy,
            approx=infer_cfg.approx_topk)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_valid.append(valid)

    boxes = torch.cat(all_boxes, dim=1)
    # clip to image bounds (predicted border distances are unconstrained)
    boxes[..., 0::2].clamp_(0.0, w - 1)
    boxes[..., 1::2].clamp_(0.0, h - 1)
    scores = torch.cat(all_scores, dim=1)
    valid = torch.cat(all_valid, dim=1)

    # pre-NMS cap: greedy NMS is O(K^2) + K sequential steps
    kcap = infer_cfg.pre_nms_topk
    if kcap and boxes.shape[1] > kcap:
        masked = scores.masked_fill(~valid, float("-inf"))
        _, sel = topk_stable(masked, kcap)
        boxes, scores, valid = (_take(boxes, sel), _take(scores, sel),
                                _take(valid, sel))
    return boxes, scores, valid


def detect_batch(model, images: torch.Tensor, infer_cfg: InferCfg,
                 label_cfg: LabelCfg) -> Dict[str, torch.Tensor]:
    """Full pyramid detect on a (B, H, W, 3) batch with ``model``'s weights
    (``DenseBox`` or the int8 ``QuantDenseBox``), on the images' device. Returns boxes (B, max_dets, 4), scores
    (B, max_dets), valid (B, max_dets). ``infer_cfg.nms_backend`` is not
    read: on the card NMS is always the CUDA kernel."""
    boxes, scores, valid = candidates(model, images, infer_cfg, label_cfg)
    boxes, scores, valid = nms(boxes, scores, valid,
                               iou_thresh=infer_cfg.nms_iou,
                               max_out=infer_cfg.max_dets)
    return {"boxes": boxes, "scores": scores, "valid": valid}


def make_detect_fn(model, infer_cfg: InferCfg, label_cfg: LabelCfg):
    """fn(images (B, H, W, 3)) -> detections dict, in inference mode with
    ``model`` in eval mode. (The JAX version jits and takes params; here the
    weights live in the model and PyTorch runs eagerly.)"""
    model.eval()

    @torch.inference_mode()
    def fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detect_batch(model, images, infer_cfg, label_cfg)

    return fn
