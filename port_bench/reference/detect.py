"""Plain detection after the forward: per-scale top-k decode, the
cross-scale concat, clip and cap, greedy NMS per image, and the landmark
peak search (paper §2, §4), with the configuration's ``infer`` and
``label`` groups.

Every float operation is taken one at a time in the dtype given (float32
for the reference, bfloat16 for the control), and every division by a
number divides by a tensor of it, so that it rounds once on every device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis; among ties the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode(score: torch.Tensor, loc: torch.Tensor, *, stride: int,
           loc_norm: float, topk: int, thresh: float, sx: float, sy: float):
    """(B, h, w[, 1]) scores and (B, h, w, 4) border distances -> the top
    ``topk`` pixels' boxes (B, K, 4) xyxy in image coordinates, scores and
    validity (score > thresh)."""
    b, h, w = score.shape[:3]
    k = min(topk, h * w)
    scores, idx = topk_stable(score.reshape(b, h * w), k)
    iy = torch.div(idx, w, rounding_mode="floor").to(score.dtype)
    ix = (idx % w).to(score.dtype)
    d = torch.gather(loc.reshape(b, h * w, 4), 1,
                     idx[..., None].expand(b, k, 4)) * loc_norm
    boxes = torch.stack([_div((ix - d[..., 0]) * stride, sx),
                         _div((iy - d[..., 1]) * stride, sy),
                         _div((ix + d[..., 2]) * stride, sx),
                         _div((iy + d[..., 3]) * stride, sy)], dim=-1)
    valid = scores > thresh
    if k < topk:
        pad = topk - k
        boxes = torch.cat([boxes, boxes.new_zeros(b, pad, 4)], 1)
        scores = torch.cat([scores, scores.new_full((b, pad), float("-inf"))],
                           1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], 1)
    return boxes, scores, valid


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) xyxy boxes."""
    def area(t):
        return ((t[..., 2] - t[..., 0]).clamp_min(0)
                * (t[..., 3] - t[..., 1]).clamp_min(0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_nms(boxes, scores, valid, iou_thresh: float, max_out: int):
    """Greedy NMS per image: sort by score (stable), a kept box suppresses
    every later one above ``iou_thresh``, then the ``max_out`` best kept.
    Returns boxes, scores, valid and each slot's candidate index."""
    b, k = scores.shape
    order = torch.sort(scores.masked_fill(~valid, float("-inf")), dim=1,
                       descending=True, stable=True).indices
    boxes = torch.gather(boxes, 1, order[..., None].expand(b, k, 4))
    scores = torch.gather(scores, 1, order)
    valid = torch.gather(valid, 1, order)
    ar = torch.arange(k, device=boxes.device)
    hits = (iou(boxes, boxes) > iou_thresh) & (ar[None, :] > ar[:, None])
    keep = valid.clone()
    for i in range(k):
        keep &= ~(hits[:, i] & keep[:, i:i + 1])
    out_scores, sel = topk_stable(scores.masked_fill(~keep, float("-inf")),
                                  min(max_out, k))
    n = sel.shape[1]
    res = [torch.gather(boxes, 1, sel[..., None].expand(b, n, 4)), out_scores,
           torch.gather(keep, 1, sel), torch.gather(order, 1, sel)]
    if max_out > k:
        pad = max_out - k
        res[0] = torch.cat([res[0], res[0].new_zeros(b, pad, 4)], 1)
        res[1] = torch.cat([res[1], res[1].new_full((b, pad), float("-inf"))],
                           1)
        res[2] = torch.cat([res[2], res[2].new_zeros(b, pad)], 1)
        res[3] = torch.cat([res[3], res[3].new_zeros(b, pad)], 1)
    return res


def landmarks(lm_maps: Sequence[Tuple[torch.Tensor, Tuple[float, float]]],
              sel, boxes, valid, *, stride: int, anchors, anchor_radius: float,
              window: int = 32, margin_px: float = 1.5):
    """Each detection's landmarks from its selected scale's heatmaps: a
    ``window``-sized crop around the expected position (the anchor, else
    the box centre), the masked argmax over the box dilated by
    ``margin_px`` map pixels (and with anchors a disc around the anchor)
    plus a tiny centred prior, a parabola per axis for the sub-pixel
    offset, and the box centre where no peak qualifies. Returns points
    (B, D, L, 2) and their validity (B, D, L)."""
    b, d = sel.shape
    dev = boxes.device
    num_lm = lm_maps[0][0].shape[-1]
    hs = [m.shape[1] for m, _ in lm_maps]
    ws = [m.shape[2] for m, _ in lm_maps]
    win = int(min(window, min(hs), min(ws)))
    stacked = lm_maps[0][0].new_zeros((b, len(lm_maps), num_lm, max(hs),
                                       max(ws)))
    for s, (m, _) in enumerate(lm_maps):
        stacked[:, s, :, :m.shape[1], :m.shape[2]] = m.permute(0, 3, 1, 2)
    sel = sel.long()

    def per_det(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)[sel][..., None]

    sx = per_det([v[0] for _, v in lm_maps], torch.float32)
    sy = per_det([v[1] for _, v in lm_maps], torch.float32)
    w_sel = per_det(ws, torch.int32)
    h_sel = per_det(hs, torch.int32)
    x1, y1, x2, y2 = (boxes[..., i, None] for i in range(4))
    aw, ah = x2 - x1, y2 - y1
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    if anchors is not None:
        anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
        ex, ey = x1 + anc[:, 0] * aw, y1 + anc[:, 1] * ah
    else:
        ex, ey = cx, cy
    x0 = torch.minimum((torch.floor(_div(ex * sx, stride)).int()
                        - win // 2).clamp_min(0), w_sel - win)
    y0 = torch.minimum((torch.floor(_div(ey * sy, stride)).int()
                        - win // 2).clamp_min(0), h_sel - win)
    ar = torch.arange(win, device=dev)
    rows = (y0.long()[..., None] + ar)[..., :, None]
    cols = (x0.long()[..., None] + ar)[..., None, :]
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    li = torch.arange(num_lm, device=dev)[None, None, :, None, None]
    patches = stacked[bi, sel[:, :, None, None, None], li, rows, cols]

    xs = ((x0[..., None] + ar).float() * stride / sx[..., None])[..., None, :]
    ys = ((y0[..., None] + ar).float() * stride / sy[..., None])[..., :, None]

    def e5(t):
        return t[..., None, None]

    def same(t):
        return t

    mx, my = _rdiv(margin_px * stride, sx), _rdiv(margin_px * stride, sy)
    rad = (torch.maximum(anchor_radius * torch.sqrt(aw * aw + ah * ah),
                         _rdiv(2.0 * stride, torch.minimum(sx, sy)))
           if anchors is not None else None)

    def allowed(xs_, ys_, up):
        ok = ((xs_ >= up(x1 - mx)) & (xs_ <= up(x2 + mx))
              & (ys_ >= up(y1 - my)) & (ys_ <= up(y2 + my)))
        if rad is not None:
            dx, dy = xs_ - up(ex), ys_ - up(ey)
            ok = ok & (dx * dx + dy * dy <= up(rad * rad))
        return ok

    dxc = _div((xs - e5(cx)) * e5(sx), stride)
    dyc = _div((ys - e5(cy)) * e5(sy), stride)
    prior = -1e-5 * (dxc * dxc + dyc * dyc)
    masked = torch.where(allowed(xs, ys, e5), patches + prior, float("-inf"))
    idx = masked.reshape(b, d, num_lm, win * win).argmax(-1)
    jx0, jy0 = idx % win, idx // win
    ix, iy = (x0 + jx0).float(), (y0 + jy0).float()
    ok = allowed(ix * stride / sx, iy * stride / sy, same)
    kx_lo = (torch.ceil(_div(x1 * sx, stride)) - x0).clamp_min(0)
    kx_hi = (torch.floor(_div(x2 * sx, stride)) - x0).clamp_max(win - 1)
    ky_lo = (torch.ceil(_div(y1 * sy, stride)) - y0).clamp_min(0)
    ky_hi = (torch.floor(_div(y2 * sy, stride)) - y0).clamp_max(win - 1)
    ok = ok & (kx_lo <= kx_hi) & (ky_lo <= ky_hi)
    if anchors is None:
        ok = ok & (_div(aw * sx, stride) <= win) & (_div(ah * sy, stride) <= win)
    ok = ok.expand(b, d, num_lm)
    flat = patches.reshape(b, d, num_lm, win * win)

    def at(jy, jx):
        j = jy.clamp(0, win - 1) * win + jx.clamp(0, win - 1)
        return flat.gather(-1, j[..., None])[..., 0].float()

    def vertex(lo, c, hi):
        den = lo - 2.0 * c + hi
        dd = 0.5 * (lo - hi) / torch.where(den.abs() < 1e-6, 1e-6, den)
        return dd.clamp(-0.5, 0.5)

    c = at(jy0, jx0)
    ix = ix + vertex(at(jy0, jx0 - 1), c, at(jy0, jx0 + 1))
    iy = iy + vertex(at(jy0 - 1, jx0), c, at(jy0 + 1, jx0))
    pts = torch.stack([ix * stride / sx, iy * stride / sy], dim=-1)
    centre = torch.stack([cx.expand(b, d, num_lm), cy.expand(b, d, num_lm)],
                         dim=-1)
    pts = torch.where(ok[..., None], pts, centre)
    pts = torch.where(valid[..., None, None], pts, 0.0)
    return pts, ok & valid[..., None]


def detect(levels: List[Tuple[Dict[str, torch.Tensor], Tuple[float, float]]],
           image_hw: Tuple[int, int], infer: dict, label: dict,
           dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Detections of a batch from its maps at every pyramid scale (each
    with its (sx, sy)): boxes (B, max_dets, 4), scores, valid and, with
    ``lm`` maps, lm_points and lm_valid. ``dtype`` is what the decode
    computes in (float32; bfloat16 for the control)."""
    h, w = image_hw
    stride = label["stride"]
    loc_norm = label["std_height_px"] / stride
    parts = [[], [], [], []]
    for s, (out, (sx, sy)) in enumerate(levels):
        smap = out.get("refined", out["score"]).to(dtype)
        bx, sc, va = decode(smap, out["loc"].to(dtype), stride=stride,
                            loc_norm=loc_norm, topk=infer["topk_per_scale"],
                            thresh=infer["score_thresh"], sx=sx, sy=sy)
        for p, t in zip(parts, (bx, sc, va, torch.full(
                sc.shape, s, dtype=torch.int32, device=sc.device))):
            p.append(t)
    boxes, scores, valid, src = (torch.cat(p, dim=1) for p in parts)
    boxes[..., 0::2].clamp_(0.0, w - 1)
    boxes[..., 1::2].clamp_(0.0, h - 1)
    kcap = infer["pre_nms_topk"]
    if kcap and boxes.shape[1] > kcap:
        _, keep = topk_stable(scores.masked_fill(~valid, float("-inf")), kcap)
        boxes = torch.gather(boxes, 1, keep[..., None].expand(*keep.shape, 4))
        scores, valid, src = (torch.gather(t, 1, keep)
                              for t in (scores, valid, src))
    boxes, scores, valid, kept = greedy_nms(boxes.float(), scores.float(),
                                            valid, infer["nms_iou"],
                                            infer["max_dets"])
    res = {"boxes": boxes, "scores": scores, "valid": valid}
    if "lm" not in levels[0][0]:
        return res
    ld = torch.bfloat16 if infer["lm_dtype"] in ("auto", "bfloat16") \
        else torch.float32
    lm_maps = [(o["lm"].to(ld), xy) for o, xy in levels]
    src = torch.gather(src, 1, kept)
    if infer["lm_decode"] == "std":
        hgt = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)
        mis = torch.stack([torch.log(_div(hgt * sy, label["std_height_px"]))
                           .abs() for _, (_, sy) in levels], dim=-1)
        sel = mis.argmin(-1).int()
    elif infer["lm_decode"] == "finest":
        best = max(range(len(levels)),
                   key=lambda s: levels[s][1][0] * levels[s][1][1])
        sel = torch.full(boxes.shape[:2], best, dtype=torch.int32,
                         device=boxes.device)
    else:
        sel = src
    kd = boxes.shape[1]
    if infer["lm_topk"] and infer["lm_topk"] < kd:
        kd = infer["lm_topk"]
    anchors = label.get("lm_anchors") or None
    pts, ok = landmarks(lm_maps, sel[:, :kd], boxes[:, :kd], valid[:, :kd],
                        stride=stride, anchors=anchors,
                        anchor_radius=label["lm_anchor_radius"])
    pad = boxes.shape[1] - kd
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pts.shape[0], pad)
                                            + pts.shape[2:])], 1)
        ok = torch.cat([ok, ok.new_zeros((ok.shape[0], pad) + ok.shape[2:])],
                       1)
    res["lm_points"], res["lm_valid"] = pts, ok
    return res
