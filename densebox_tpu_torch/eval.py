"""Evaluation: detection AP (VOC-continuous and the KITTI protocol's AP|R40
by difficulty), heatmap MSE and landmark NME (port of
``densebox_tpu/eval.py``; numpy, on the host: eval is not a hot path).

``detections_to_numpy`` takes the port's detection dicts, whose tensors may
lie on the card.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def _iou_one_to_many(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    if len(others) == 0:
        return np.zeros((0,), np.float32)
    x1 = np.maximum(box[0], others[:, 0])
    y1 = np.maximum(box[1], others[:, 1])
    x2 = np.minimum(box[2], others[:, 2])
    y2 = np.minimum(box[3], others[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (others[:, 2] - others[:, 0]) * (others[:, 3] - others[:, 1])
    return inter / np.maximum(a + b - inter, 1e-9)


def match_image(pred_boxes: np.ndarray, pred_scores: np.ndarray,
                gt_boxes: np.ndarray, iou_thresh: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy score-ordered matching for one image.
    Returns (scores, is_tp) for every prediction."""
    order = np.argsort(-pred_scores)
    taken = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(order), bool)
    for r, i in enumerate(order):
        ious = _iou_one_to_many(pred_boxes[i], gt_boxes)
        ious[taken] = -1.0
        j = int(np.argmax(ious)) if len(ious) else -1
        if j >= 0 and ious[j] >= iou_thresh:
            taken[j] = True
            tp[r] = True
    return pred_scores[order], tp


def average_precision(scores: np.ndarray, is_tp: np.ndarray,
                      n_gt: int) -> float:
    """VOC-continuous AP (area under the interpolated PR curve)."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = is_tp[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    recall = cum_tp / n_gt
    precision = cum_tp / (np.arange(len(tp)) + 1)
    # monotone-interpolated precision
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # integrate over recall deltas
    r_prev = 0.0
    ap = 0.0
    for p, r in zip(precision, recall):
        ap += p * (r - r_prev)
        r_prev = r
    return float(ap)


def evaluate_detections(
    per_image: Iterable[Dict[str, np.ndarray]],
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """per_image entries: {pred_boxes (P,4), pred_scores (P,),
    gt_boxes (G,4)} with padding already stripped.
    Returns {'ap': ..., 'n_gt': ..., 'n_pred': ...}."""
    all_scores: List[np.ndarray] = []
    all_tp: List[np.ndarray] = []
    n_gt = n_pred = 0
    for item in per_image:
        s, tp = match_image(item["pred_boxes"], item["pred_scores"],
                            item["gt_boxes"], iou_thresh)
        all_scores.append(s)
        all_tp.append(tp)
        n_gt += len(item["gt_boxes"])
        n_pred += len(s)
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    return {"ap": average_precision(scores, tps, n_gt),
            "n_gt": float(n_gt), "n_pred": float(n_pred)}


# --- KITTI official protocol -------------------------------------------
#
# The official devkit protocol differs from VOC in three ways implemented
# here:
# difficulty bins over (bbox height, occlusion, truncation), ignore
# semantics (out-of-bin GTs, DontCare regions, and sub-min-height
# detections are neither TP nor FP), and 40-recall-point AP interpolation.

KITTI_DIFFICULTIES = {
    # difficulty: (min bbox height px, max occlusion level, max truncation)
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}


def _ioa(boxes: np.ndarray, regions: np.ndarray) -> np.ndarray:
    """Intersection-over-det-area of each box against each region —
    the devkit's DontCare overlap criterion (not IoU)."""
    if len(boxes) == 0 or len(regions) == 0:
        return np.zeros((len(boxes), len(regions)), np.float32)
    x1 = np.maximum(boxes[:, None, 0], regions[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], regions[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], regions[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], regions[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = ((boxes[:, 2] - boxes[:, 0])
            * (boxes[:, 3] - boxes[:, 1]))[:, None]
    return inter / np.maximum(area, 1e-9)


def match_image_kitti(
    pred_boxes: np.ndarray, pred_scores: np.ndarray,
    gt_boxes: np.ndarray, gt_ignored: np.ndarray,
    dontcare: np.ndarray, iou_thresh: float, min_height: float,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy matching with KITTI ignore semantics for one image.

    Returns ``(scores, is_tp, n_gt)`` over the *counted* predictions only;
    predictions are dropped (neither TP nor FP) when they match an ignored
    GT, overlap a DontCare region (intersection/area > 0.5), or are
    shorter than the difficulty's min height while unmatched."""
    order = np.argsort(-pred_scores)
    taken = np.zeros(len(gt_boxes), bool)
    keep_scores: List[float] = []
    keep_tp: List[bool] = []
    for i in order:
        ious = _iou_one_to_many(pred_boxes[i], gt_boxes)
        cand = np.where(~taken & (ious >= iou_thresh))[0]
        # prefer a relevant (non-ignored) GT over an ignored one even at
        # lower IoU — a det is only discarded when nothing relevant matches
        relevant = cand[~gt_ignored[cand]] if len(cand) else cand
        if len(relevant):
            j = relevant[np.argmax(ious[relevant])]
            taken[j] = True
            keep_scores.append(pred_scores[i])
            keep_tp.append(True)
            continue
        if len(cand):                    # matches only ignored GTs
            taken[cand[np.argmax(ious[cand])]] = True
            continue
        if len(dontcare) and _ioa(pred_boxes[i:i + 1], dontcare).max() > 0.5:
            continue
        if (pred_boxes[i, 3] - pred_boxes[i, 1]) < min_height:
            continue                     # too small to be annotated
        keep_scores.append(pred_scores[i])
        keep_tp.append(False)
    n_gt = int((~gt_ignored).sum())
    return (np.asarray(keep_scores, np.float32),
            np.asarray(keep_tp, bool), n_gt)


def average_precision_r40(scores: np.ndarray, is_tp: np.ndarray,
                          n_gt: int) -> float:
    """KITTI AP|R40: mean of interpolated precision at recall 1/40..40/40."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = is_tp[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    recall = cum_tp / n_gt
    precision = cum_tp / (np.arange(len(tp)) + 1)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    pts = np.arange(1, 41) / 40.0
    interp = np.zeros(40)
    for k, r in enumerate(pts):
        idx = np.searchsorted(recall, r, side="left")
        if idx < len(precision):
            interp[k] = precision[idx]
    return float(interp.mean())


def evaluate_kitti(
    per_image: Iterable[Dict[str, np.ndarray]],
    iou_thresh: float = 0.7,
) -> Dict[str, float]:
    """Official-protocol KITTI AP per difficulty bin.

    per_image entries: {pred_boxes (P,4), pred_scores (P,), gt_boxes (G,4)}
    plus optional {gt_truncation (G,), gt_occlusion (G,), dontcare (M,4)}
    (missing metadata means fully visible / no DontCare, so synthetic data
    evaluates as all-relevant). Returns {'ap_easy', 'ap_moderate',
    'ap_hard', 'n_gt_<difficulty>', ...}."""
    items = list(per_image)
    out: Dict[str, float] = {}
    for name, (min_h, max_occ, max_trunc) in KITTI_DIFFICULTIES.items():
        all_scores: List[np.ndarray] = []
        all_tp: List[np.ndarray] = []
        n_gt = 0
        for item in items:
            gt = item["gt_boxes"]
            g = len(gt)
            trunc = np.asarray(item.get("gt_truncation",
                                        np.zeros(g)), np.float32)
            occ = np.asarray(item.get("gt_occlusion",
                                      np.zeros(g)), np.int64)
            heights = gt[:, 3] - gt[:, 1] if g else np.zeros(0)
            ignored = ((heights < min_h) | (occ > max_occ)
                       | (trunc > max_trunc))
            dc = np.asarray(item.get("dontcare",
                                     np.zeros((0, 4))), np.float32)
            s, tp, n = match_image_kitti(
                item["pred_boxes"], item["pred_scores"], gt, ignored, dc,
                iou_thresh, min_height=min_h)
            all_scores.append(s)
            all_tp.append(tp)
            n_gt += n
        scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
        tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
        out[f"ap_{name}"] = average_precision_r40(scores, tps, n_gt)
        out[f"n_gt_{name}"] = float(n_gt)
    return out


def as_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detections_to_numpy(dets: Dict, gts_boxes, gts_valid
                        ) -> List[Dict[str, np.ndarray]]:
    """Strip padding from a detect_batch output + padded GT tensors."""
    out = []
    boxes = as_numpy(dets["boxes"])
    scores = as_numpy(dets["scores"])
    valid = as_numpy(dets["valid"])
    gts_boxes, gts_valid = as_numpy(gts_boxes), as_numpy(gts_valid)
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append({
            "pred_boxes": boxes[i][v],
            "pred_scores": scores[i][v],
            "gt_boxes": gts_boxes[i][gts_valid[i]],
        })
    return out


def heatmap_mse(a: Dict, b: Dict) -> Dict[str, float]:
    """Per-head mean-squared-error between two dense-output dicts."""
    return {k: float(np.mean((as_numpy(a[k]) - as_numpy(b[k])) ** 2))
            for k in a if k in b}


def landmark_nme(pred_pts: np.ndarray, gt_pts: np.ndarray,
                 norm: np.ndarray, mask: np.ndarray = None) -> float:
    """Normalized mean error, the landmark metric.
    pred/gt (N, L, 2); norm (N,) per-instance normalizer (e.g. box
    height or inter-ocular distance); optional (N, L) bool mask excludes
    invisible/unlabeled keypoints (real-data annotations, data/kitti.py)."""
    pred = np.asarray(pred_pts, np.float64)
    gt = np.asarray(gt_pts, np.float64)
    d = np.linalg.norm(pred - gt, axis=-1)            # (N, L)
    e = d / np.maximum(np.asarray(norm, np.float64)[:, None], 1e-9)
    if mask is not None:
        m = np.asarray(mask, bool)
        if not m.any():
            return float("nan")
        return float(e[m].mean())
    return float(np.mean(e))
