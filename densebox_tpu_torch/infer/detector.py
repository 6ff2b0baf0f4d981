"""Image-pyramid detection (port of ``densebox_tpu/infer/detector.py``).

Per scale: linear resize (``infer.resize``), forward, fixed-K top-k decode
(of the refine branch's score map when the model has one); then the
cross-scale concat, clip to the image, the ``pre_nms_topk`` cap and one
greedy NMS per image. With a landmark model, each detection's landmarks are
decoded from one pyramid scale's heatmaps by a windowed peak search; the
window gather is ``ops.kernels.window``. Shapes are fixed as in the JAX
program: every image yields ``max_dets`` slots with a validity bit.

``detect_batch`` is ``pyramid_maps`` (the forward at every scale) followed
by ``detect_from_maps`` (everything after it), so that the part after the
forward can also run on another device's copy of the same maps.

Every division by a Python number goes through ``ops.decode.div`` or
``rdiv``, and every float operation stays separate (no fused
multiply-adds), so the card rounds as the CPU does and both round as the
JAX package run without jit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from densebox_tpu_torch.config import InferCfg, LabelCfg
from densebox_tpu_torch.infer.resize import resize_linear
from densebox_tpu_torch.ops.decode import decode_topk, div, rdiv, topk_stable
from densebox_tpu_torch.ops.nms import nms
from densebox_tpu_torch.ops.window import gather_windows
from densebox_tpu_torch.utils.constants import constant_cache
from densebox_tpu_torch.utils.logging import new_span_id, span, spans_under

# per-scale model outputs with that scale's (sx, sy) factors
Levels = List[Tuple[Dict[str, torch.Tensor], Tuple[float, float]]]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolved_lm_dtype(infer_cfg: InferCfg) -> str:
    """``InferCfg.lm_dtype`` with ``'auto'`` resolved to ``'bfloat16'``, the
    JAX package's policy."""
    ld = infer_cfg.lm_dtype
    return "bfloat16" if ld == "auto" else ld


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


@constant_cache
def _table(values: tuple, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A small constant tensor on the device, made once per value (an
    upload from pageable memory on every call would stall the host until
    the card drains its queue). Read-only."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def _anchor_tensor(anchors, device) -> torch.Tensor:
    """(L, 2) float32 anchors (any nested sequence or array) on ``device``."""
    if anchors is None:
        return None
    rows = tuple(tuple(float(v) for v in row) for row in anchors)
    return _table(rows, torch.float32, torch.device(device))


def _vertex(lo: torch.Tensor, c: torch.Tensor, hi: torch.Tensor
            ) -> torch.Tensor:
    """Sub-pixel offset of the parabola through (-1, lo), (0, c), (1, hi),
    clipped to half a pixel."""
    eps = 1e-6
    denom = lo - 2.0 * c + hi
    delta = 0.5 * (lo - hi) / torch.where(denom.abs() < eps, eps, denom)
    return delta.clamp(-0.5, 0.5)


def decode_landmarks(
    lm_map: torch.Tensor,    # (h, w, L) landmark heatmaps at stride `stride`
    boxes: torch.Tensor,     # (D, 4) xyxy, original-image coords
    valid: torch.Tensor,     # (D,) bool
    *,
    stride: int,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
    subpixel: bool = True,
    window: int = 32,
    margin_px: float = 1.5,  # box dilation for the peak mask, in MAP pixels
    anchors=None,            # optional (L, 2) box-relative expected positions
    anchor_radius: float = 0.25,
) -> torch.Tensor:
    """Single-image landmark decode, the reference the batched decode is
    held against (port of ``densebox_tpu.infer.detector.decode_landmarks``).

    For each detection and landmark: a ``window``-sized crop centred on the
    expected position (the anchor, or the box centre), a masked argmax over
    the box dilated by ``margin_px`` map pixels (and, with anchors, a disc
    around the anchor) with a tiny centred prior, then a 1-D parabola per
    axis for the sub-pixel position. A box with no strict-interior pixel in
    the window, or an anchor-less box larger than the window, falls back to
    the box centre. Returns (D, L, 2) xy in original-image coords, zeros for
    invalid detections."""
    h, w, num_lm = lm_map.shape
    win = int(min(window, h, w))
    nd = boxes.shape[0]
    dev = boxes.device
    anchors = _anchor_tensor(anchors, dev)
    x1, y1, x2, y2 = (boxes[:, i, None] for i in range(4))    # (D, 1)
    aw_ = x2 - x1
    ah_ = y2 - y1
    cx = 0.5 * (x1 + x2)
    cy = 0.5 * (y1 + y2)
    if anchors is not None:
        ex = x1 + anchors[:, 0] * aw_                           # (D, L)
        ey = y1 + anchors[:, 1] * ah_
    else:
        ex = cx.expand(nd, num_lm)
        ey = cy.expand(nd, num_lm)

    x0 = (torch.floor(div(ex * scale_x, stride)).int()
          - win // 2).clamp(0, w - win)                         # (D, L)
    y0 = (torch.floor(div(ey * scale_y, stride)).int()
          - win // 2).clamp(0, h - win)
    maps = lm_map.permute(2, 0, 1)[None, None].contiguous()    # (1, 1, L, h, w)
    patch = gather_windows(maps, torch.zeros((1, nd), dtype=torch.int32,
                                             device=dev),
                           y0[None].contiguous(), x0[None].contiguous(),
                           win)[0]                              # (D, L, win, win)

    ar = torch.arange(win, device=dev)
    xs = div((x0[..., None] + ar).float() * stride,
             scale_x)[..., None, :]                             # (D, L, 1, win)
    ys = div((y0[..., None] + ar).float() * stride,
             scale_y)[..., :, None]                             # (D, L, win, 1)

    def bx(t):   # (D, 1|L) -> against (D, L, win, win)
        return t[..., None, None]

    mx = margin_px * stride / scale_x
    my = margin_px * stride / scale_y
    inside = ((xs >= bx(x1 - mx)) & (xs <= bx(x2 + mx)) &
              (ys >= bx(y1 - my)) & (ys <= bx(y2 + my)))
    strict = ((xs >= bx(x1)) & (xs <= bx(x2)) &
              (ys >= bx(y1)) & (ys <= bx(y2)))
    dx_c = div((xs - bx(cx)) * scale_x, stride)
    dy_c = div((ys - bx(cy)) * scale_y, stride)
    prior = -1e-5 * (dx_c * dx_c + dy_c * dy_c)
    allowed = inside
    if anchors is not None:
        rad = torch.clamp_min(anchor_radius * torch.sqrt(aw_ * aw_ + ah_ * ah_),
                              2.0 * stride / min(scale_x, scale_y))
        dx = xs - bx(ex)
        dy = ys - bx(ey)
        allowed = allowed & (dx * dx + dy * dy <= bx(rad * rad))
    masked = torch.where(allowed, patch + prior, float("-inf"))
    flat = masked.reshape(nd, num_lm, win * win)
    flat_patch = patch.reshape(nd, num_lm, win * win)
    idx = flat.argmax(-1)                                       # (D, L)
    peak_ok = (strict.flatten(2).any(-1)
               & torch.isfinite(flat.gather(-1, idx[..., None])[..., 0]))
    if anchors is None:
        span_ok = ((div(aw_ * scale_x, stride) <= win) &
                   (div(ah_ * scale_y, stride) <= win))
        peak_ok = peak_ok & span_ok
    jx0 = idx % win
    jy0 = idx // win
    ix = (x0 + jx0).float()
    iy = (y0 + jy0).float()

    if subpixel:
        def at(dy, dx):
            j = ((jy0 + dy).clamp(0, win - 1) * win
                 + (jx0 + dx).clamp(0, win - 1))
            return flat_patch.gather(-1, j[..., None])[..., 0]

        c = at(0, 0)
        ix = ix + _vertex(at(0, -1), c, at(0, 1))
        iy = iy + _vertex(at(-1, 0), c, at(1, 0))

    pts = torch.stack([div(ix * stride, scale_x), div(iy * stride, scale_y)],
                      dim=-1)
    center = torch.stack([((x1 + x2) * 0.5).expand(nd, num_lm),
                          ((y1 + y2) * 0.5).expand(nd, num_lm)], dim=-1)
    pts = torch.where(peak_ok[..., None], pts, center)
    return torch.where(valid[:, None, None], pts, 0.0)


def decode_landmarks_selected(
    lm_maps: Sequence[Tuple[torch.Tensor, Tuple[float, float]]],
    sel: torch.Tensor,       # (B, D) int selected pyramid scale per detection
    boxes: torch.Tensor,     # (B, D, 4) xyxy, original-image coords
    valid: torch.Tensor,     # (B, D) bool
    *,
    stride: int,
    subpixel: bool = True,
    window: int = 32,
    margin_px: float = 1.5,
    anchors=None,            # optional (L, 2) box-relative expected positions
    anchor_radius: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched landmark decode reading each detection's selected scale only
    (port of ``densebox_tpu.infer.detector.decode_landmarks_selected``).

    ``lm_maps`` holds one ((B, h_s, w_s, L) heatmap, (sx_s, sy_s)) per
    pyramid scale. The decode of ``decode_landmarks``, in this order: stack
    the maps channels-leading over a padded common shape; look up each
    detection's scale factors and map size; window origins (per landmark
    with anchors, shared (B, D, 1) without); one ``gather_windows`` for all
    windows; the masked argmax with the centred prior; peak validity in
    closed form (the argmax pixel allowed, a strict-interior pixel in the
    window, and without anchors a box no larger than the window); the
    sub-pixel parabola; the centre fallback.

    Returns ``(points (B, D, L, 2) f32, lm_valid (B, D, L) bool)``:
    ``lm_valid`` is False where the box-centre fallback was used and for
    invalid detections (whose points are zero)."""
    num_scales = len(lm_maps)
    num_lm = lm_maps[0][0].shape[-1]
    b, d = sel.shape
    dev = boxes.device
    hs = [m.shape[1] for m, _ in lm_maps]
    ws = [m.shape[2] for m, _ in lm_maps]
    win = int(min(window, min(hs), min(ws)))
    anchors = _anchor_tensor(anchors, dev)

    # stack channels-leading over a padded common shape; the pad is never
    # read (origins are clipped per scale)
    stacked = lm_maps[0][0].new_zeros((b, num_scales, num_lm, max(hs), max(ws)))
    for s, (m, _) in enumerate(lm_maps):
        stacked[:, s, :, :m.shape[1], :m.shape[2]] = m.permute(0, 3, 1, 2)

    sel = sel.int().contiguous()

    def per_det(values, dtype):   # per-scale values -> (B, D, 1) by sel
        return _table(tuple(values), dtype, dev)[sel][..., None]

    sx = per_det([sx for _, (sx, _) in lm_maps], torch.float32)
    sy = per_det([sy for _, (_, sy) in lm_maps], torch.float32)
    w_sel = per_det(ws, torch.int32)
    h_sel = per_det(hs, torch.int32)

    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))   # (B, D, 1)
    aw_ = x2 - x1
    ah_ = y2 - y1
    cx = 0.5 * (x1 + x2)
    cy = 0.5 * (y1 + y2)
    if anchors is not None:
        ex = x1 + anchors[:, 0] * aw_                            # (B, D, L)
        ey = y1 + anchors[:, 1] * ah_
    else:
        # anchor-less: every channel searches the box-centre window, so the
        # origins stay (B, D, 1) and the gather copies all L channels at once
        ex, ey = cx, cy                                          # (B, D, 1)

    x0 = torch.minimum((torch.floor(div(ex * sx, stride)).int()
                        - win // 2).clamp_min(0), w_sel - win).contiguous()
    y0 = torch.minimum((torch.floor(div(ey * sy, stride)).int()
                        - win // 2).clamp_min(0), h_sel - win).contiguous()

    patches = gather_windows(stacked, sel, y0, x0, win)  # (B, D, L, win, win)

    # original-image coords of each window's pixels
    ar = torch.arange(win, device=dev)
    xs = ((x0[..., None] + ar).float() * stride
          / sx[..., None])[..., None, :]                 # (B, D, L|1, 1, win)
    ys = ((y0[..., None] + ar).float() * stride
          / sy[..., None])[..., :, None]                 # (B, D, L|1, win, 1)

    def e5(t):   # (B, D, L|1) -> against (B, D, L, win, win)
        return t[..., None, None]

    def ident(t):
        return t

    mx = rdiv(margin_px * stride, sx)
    my = rdiv(margin_px * stride, sy)
    rad = (torch.maximum(anchor_radius * torch.sqrt(aw_ * aw_ + ah_ * ah_),
                         rdiv(2.0 * stride, torch.minimum(sx, sy)))
           if anchors is not None else None)             # (B, D, 1)

    def allowed_mask(xs_, ys_, up):
        """Search mask at coords; ``up`` lifts (B, D, L|1) values to
        broadcast against them."""
        ok = ((xs_ >= up(x1 - mx)) & (xs_ <= up(x2 + mx)) &
              (ys_ >= up(y1 - my)) & (ys_ <= up(y2 + my)))
        if rad is not None:
            dx = xs_ - up(ex)
            dy = ys_ - up(ey)
            ok = ok & (dx * dx + dy * dy <= up(rad * rad))
        return ok

    dx_c = div((xs - e5(cx)) * e5(sx), stride)
    dy_c = div((ys - e5(cy)) * e5(sy), stride)
    prior = -1e-5 * (dx_c * dx_c + dy_c * dy_c)
    masked = torch.where(allowed_mask(xs, ys, e5), patches + prior,
                         float("-inf"))
    idx = masked.reshape(b, d, num_lm, win * win).argmax(-1)    # (B, D, L)
    jx0 = idx % win
    jy0 = idx // win
    ix = (x0 + jx0).float()                                      # map coords
    iy = (y0 + jy0).float()

    # peak validity without another pass over the windows: the masked max
    # is finite iff the argmax pixel is allowed (with none allowed, argmax
    # is pixel 0, which then is not), and a strict-interior pixel exists
    # iff some k in [0, win) has x1 <= (x0 + k) * stride / s <= x2 per axis
    pk_ok = allowed_mask(ix * stride / sx, iy * stride / sy, ident)
    kx_lo = (torch.ceil(div(x1 * sx, stride)) - x0).clamp_min(0)
    kx_hi = (torch.floor(div(x2 * sx, stride)) - x0).clamp_max(win - 1)
    ky_lo = (torch.ceil(div(y1 * sy, stride)) - y0).clamp_min(0)
    ky_hi = (torch.floor(div(y2 * sy, stride)) - y0).clamp_max(win - 1)
    peak_ok = pk_ok & (kx_lo <= kx_hi) & (ky_lo <= ky_hi)
    if anchors is None:
        peak_ok = (peak_ok & (div(aw_ * sx, stride) <= win)
                   & (div(ah_ * sy, stride) <= win))
    peak_ok = peak_ok.expand(b, d, num_lm)

    if subpixel:
        flat = patches.reshape(b, d, num_lm, win * win)

        def at(jy, jx):
            j = jy.clamp(0, win - 1) * win + jx.clamp(0, win - 1)
            return flat.gather(-1, j[..., None])[..., 0].float()

        c = at(jy0, jx0)
        ix = ix + _vertex(at(jy0, jx0 - 1), c, at(jy0, jx0 + 1))
        iy = iy + _vertex(at(jy0 - 1, jx0), c, at(jy0 + 1, jx0))

    pts = torch.stack([ix * stride / sx, iy * stride / sy], dim=-1)
    center = torch.stack([cx.expand(b, d, num_lm), cy.expand(b, d, num_lm)],
                         dim=-1)
    pts = torch.where(peak_ok[..., None], pts, center)
    pts = torch.where(valid[..., None, None], pts, 0.0)
    return pts, peak_ok & valid[..., None]


def pyramid_maps(model, images: torch.Tensor, infer_cfg: InferCfg) -> Levels:
    """The model's output maps at every pyramid scale of a (B, H, W, 3)
    batch, each with its (sx, sy) = (ws / W, hs / H)."""
    _, h, w, _ = images.shape
    levels = []
    for hs, ws, sy, sx in pyramid_shapes(h, w, infer_cfg.scales):
        imgs = images if (hs, ws) == (h, w) else resize_linear(images, (hs, ws))
        levels.append((model(imgs), (sx, sy)))
    return levels


def candidates(levels: Levels, image_hw: Tuple[int, int],
               infer_cfg: InferCfg, label_cfg: LabelCfg
               ) -> Tuple[torch.Tensor, ...]:
    """The NMS input of ``detect_from_maps``: per-scale top-k candidates
    (decoded from ``refined`` when the model has a refine branch, else from
    ``score``), concatenated across scales, clipped to the (H, W) image and
    capped at ``pre_nms_topk``. Returns (boxes (B, K, 4), scores (B, K),
    valid (B, K), src (B, K) int32: the pyramid scale of each candidate)."""
    h, w = image_hw
    all_boxes, all_scores, all_valid, all_src = [], [], [], []
    for s, (out, (sx, sy)) in enumerate(levels):
        boxes, scores, valid = decode_topk(
            out.get("refined", out["score"]), out["loc"],
            stride=label_cfg.stride, loc_norm=label_cfg.loc_norm,
            topk=infer_cfg.topk_per_scale,
            score_thresh=infer_cfg.score_thresh, scale_x=sx, scale_y=sy,
            approx=infer_cfg.approx_topk)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_valid.append(valid)
        all_src.append(torch.full(scores.shape, s, dtype=torch.int32,
                                  device=scores.device))

    boxes = torch.cat(all_boxes, dim=1)
    # clip to image bounds (predicted border distances are unconstrained)
    boxes[..., 0::2].clamp_(0.0, w - 1)
    boxes[..., 1::2].clamp_(0.0, h - 1)
    scores = torch.cat(all_scores, dim=1)
    valid = torch.cat(all_valid, dim=1)
    src = torch.cat(all_src, dim=1)

    # pre-NMS cap: greedy NMS is O(K^2) + K sequential steps
    kcap = infer_cfg.pre_nms_topk
    if kcap and boxes.shape[1] > kcap:
        masked = scores.masked_fill(~valid, float("-inf"))
        _, keep = topk_stable(masked, kcap)
        boxes, scores, valid, src = (_take(t, keep)
                                     for t in (boxes, scores, valid, src))
    return boxes, scores, valid, src


def lm_scale_select(boxes: torch.Tensor, src: torch.Tensor,
                    scales_xy: Sequence[Tuple[float, float]],
                    infer_cfg: InferCfg, label_cfg: LabelCfg) -> torch.Tensor:
    """The pyramid scale (B, D) int32 whose heatmaps decode each detection's
    landmarks, per ``InferCfg.lm_decode``: 'std' the scale that brings the
    box height closest to ``std_height_px`` (the default), 'finest' the
    largest scale, 'source' the scale it was found at (``src``)."""
    if infer_cfg.lm_decode == "std":
        heights = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
        mis = torch.stack(
            [torch.log(div(heights * sy, label_cfg.std_height_px)).abs()
             for _, sy in scales_xy], dim=-1)                   # (B, D, S)
        return mis.argmin(-1).int()
    if infer_cfg.lm_decode == "finest":
        s_fine = max(range(len(scales_xy)),
                     key=lambda s: scales_xy[s][0] * scales_xy[s][1])
        return torch.full(boxes.shape[:2], s_fine, dtype=torch.int32,
                          device=boxes.device)
    return src


def detect_from_maps(levels: Levels, image_hw: Tuple[int, int],
                     infer_cfg: InferCfg, label_cfg: LabelCfg
                     ) -> Dict[str, torch.Tensor]:
    """Everything of ``detect_batch`` after the forward, on the maps'
    device: decode, concat, cap, NMS and, when the maps hold ``lm``, the
    landmark decode of the top ``lm_topk`` detections."""
    with span("detect.boxes"):
        boxes, scores, valid, src = candidates(levels, image_hw, infer_cfg,
                                               label_cfg)
        boxes, scores, valid, kept = nms(boxes, scores, valid,
                                         iou_thresh=infer_cfg.nms_iou,
                                         max_out=infer_cfg.max_dets,
                                         return_idx=True)
    result = {"boxes": boxes, "scores": scores, "valid": valid}
    if "lm" not in levels[0][0]:
        return result
    with span("detect.landmarks"):
        result["lm_points"], result["lm_valid"] = _landmarks(
            levels, boxes, valid, src, kept, infer_cfg, label_cfg)
    return result


def _landmarks(levels: Levels, boxes, valid, src, kept,
               infer_cfg: InferCfg, label_cfg: LabelCfg):
    """``detect_from_maps``'s landmark decode of the top ``lm_topk``
    detections: (lm_points (B, max_dets, L, 2), lm_valid (B, max_dets, L))."""
    ld = getattr(torch, resolved_lm_dtype(infer_cfg))
    lm_maps = [(out["lm"].to(ld), xy) for out, xy in levels]
    num_lm = lm_maps[0][0].shape[-1]
    sel = lm_scale_select(boxes, torch.gather(src, 1, kept),
                          [xy for _, xy in levels], infer_cfg, label_cfg)
    anchors = label_cfg.lm_anchors or None
    if anchors is not None and len(anchors) != num_lm:
        raise ValueError(
            f"lm_anchors has {len(anchors)} points but the model emits "
            f"{num_lm} landmark channels")
    # NMS output is score-sorted, so the top lm_topk detections are a slice;
    # slots past it get zeros and lm_valid False
    kd = boxes.shape[1]
    if infer_cfg.lm_topk and infer_cfg.lm_topk < kd:
        kd = infer_cfg.lm_topk
    pts, lm_ok = decode_landmarks_selected(
        lm_maps, sel[:, :kd], boxes[:, :kd], valid[:, :kd],
        stride=label_cfg.stride, anchors=anchors,
        anchor_radius=label_cfg.lm_anchor_radius)
    pad = boxes.shape[1] - kd
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pts.shape[0], pad)
                                            + pts.shape[2:])], dim=1)
        lm_ok = torch.cat([lm_ok, lm_ok.new_zeros((lm_ok.shape[0], pad)
                                                  + lm_ok.shape[2:])], dim=1)
    return pts, lm_ok


def detect_batch(model, images: torch.Tensor, infer_cfg: InferCfg,
                 label_cfg: LabelCfg) -> Dict[str, torch.Tensor]:
    """Full pyramid detect on a (B, H, W, 3) batch with ``model``'s weights
    (``DenseBox`` or the int8 ``QuantDenseBox``), on the images' device.
    Returns boxes (B, max_dets, 4), scores (B, max_dets), valid (B,
    max_dets) and, for a landmark model, lm_points (B, max_dets, L, 2) and
    lm_valid (B, max_dets, L). ``infer_cfg.nms_backend``, ``lm_backend`` and
    ``lm_window_dp`` are TPU policies and not read: on the card NMS and the
    window gather are always the CUDA kernels.

    Spans (``utils/logging.py``'s ring), each under the call's own id:
    ``detect.pyramid`` (resize and forward at every scale; the model's
    ``model.refine`` inside it), ``detect.boxes`` (candidates and NMS) and
    ``detect.landmarks`` (the landmark decode with the window gather)."""
    with spans_under(new_span_id()):
        with span("detect.pyramid"):
            levels = pyramid_maps(model, images, infer_cfg)
        return detect_from_maps(levels, tuple(images.shape[1:3]), infer_cfg,
                                label_cfg)


def make_detect_fn(model, infer_cfg: InferCfg, label_cfg: LabelCfg):
    """fn(images (B, H, W, 3)) -> detections dict, in inference mode with
    ``model`` in eval mode. (The JAX version jits and takes params; here the
    weights live in the model and PyTorch runs eagerly.)"""
    model.eval()

    @torch.inference_mode()
    def fn(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detect_batch(model, images, infer_cfg, label_cfg)

    return fn
