"""A plain DenseBox train step (paper §3.1-3.4) in float32 with TF32 off,
with the configuration's ``label``, ``loss`` and ``train`` groups and the
step's random draws given:

1. patches: per sample a window centred on a random valid box (its height
   brought to ``std_height_px * u`` after the resize, translation
   jittered) or a random window, cropped by a linear scale-and-translate
   (triangle filter, widened when downscaling) to ``patch_size``, flipped
   at random; boxes follow;
2. the GT maps at stride 4: a disc of radius ``rc_ratio * h`` around each
   in-band box's centre is positive (the nearest centre's box gives its
   regression target), ``rnear`` more around any valid box is gray;
3. the forward with the heads' dropout mask given, the OHEM loss (every
   positive, ``neg_pos_ratio`` times as many negatives, half of them the
   hardest by a 40-step float32 threshold bisection with ties taken by the
   noise, the rest by the noise), plus ``lambda_loc`` times the L2 of the
   regression at the positives;
4. the gradient, clipped by its global norm, weight decay added, SGD with
   momentum.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from port_bench.reference.model import (forward_float, full_f32, heads,
                                        scaled)

BISECT = 40


def head_names(model: dict) -> List[str]:
    return [p for p, _ in heads(model)]


def scaled_width(model: dict) -> int:
    """The heads' hidden width."""
    return scaled(model["head_width"], model["width_mult"])


def _rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def crop_weights(n_in: int, n_out: int, scale: torch.Tensor,
                 trans: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) weights of a linear scale-and-translate: output o
    reads input position (o + 0.5 - trans) / scale - 0.5 through a triangle
    widened by 1 / scale when downscaling, normalised, zero outside."""
    dev = scale.device
    inv = _rdiv(1.0, scale)[:, None]
    ks = inv.clamp(min=1.0)
    out_pos = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    pos = out_pos * inv - trans[:, None] * inv - 0.5
    in_pos = torch.arange(n_in, dtype=torch.float32, device=dev)
    x = (pos[:, None, :] - in_pos[:, None]).abs() / ks[:, None]
    w = (1.0 - x.abs()).clamp(min=0.0)
    tot = w.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(tot.abs() > eps, w / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[:, None, :], w, 0.0)


def patches(images, boxes, box_valid, label: dict, d: Dict[str, torch.Tensor],
            neg_frac: float = 0.3, tf32: bool = False):
    """Canvases (B, Hc, Wc, 3) and their boxes -> patches, boxes in patch
    pixels and their validity."""
    b, hc, wc, _ = images.shape
    ps = float(label["patch_size"])
    idx = torch.where(box_valid, d["anchor"], -1.0).argmax(dim=1)
    has = box_valid.any(dim=1)
    a = torch.gather(boxes, 1, idx[:, None, None].expand(b, 1, 4))[:, 0]
    a_h = (a[:, 3] - a[:, 1]).clamp(min=1.0)
    a_cx, a_cy = (a[:, 0] + a[:, 2]) * 0.5, (a[:, 1] + a[:, 3]) * 0.5
    win = a_h * ps / (d["scale"] * label["std_height_px"])
    jit = d["trans"] * win[:, None]
    wx = a_cx + jit[:, 0] - win * 0.5
    wy = a_cy + jit[:, 1] - win * 0.5
    nsize = d["neg_size"] * ps
    nxy = torch.stack([d["neg_pos"][:, 0] * (float(wc) - nsize),
                       d["neg_pos"][:, 1] * (float(hc) - nsize)], dim=-1)
    neg = (d["neg"] < float(np.float32(neg_frac))) | ~has
    win = torch.where(neg, nsize, win)
    wx = torch.where(neg, nxy[:, 0], wx)
    wy = torch.where(neg, nxy[:, 1], wy)
    scale = _rdiv(ps, win)
    wh = crop_weights(hc, label["patch_size"], scale, -wy * scale)
    ww = crop_weights(wc, label["patch_size"], scale, -wx * scale)
    with full_f32(tf32):
        p = torch.einsum("bho,bhwc->bowc", wh, images)
        p = torch.einsum("bwp,bowc->bopc", ww, p)
    tb = (boxes - torch.stack([wx, wy, wx, wy], -1)[:, None]) \
        * scale[:, None, None]
    cx, cy = (tb[..., 0] + tb[..., 2]) * 0.5, (tb[..., 1] + tb[..., 3]) * 0.5
    tv = box_valid & (cx >= 0) & (cx < ps) & (cy >= 0) & (cy < ps)
    flip = d["flip"] < 0.5
    fm = flip[:, None, None]
    p = torch.where(fm[..., None], p.flip(2), p)
    tb = torch.where(fm, torch.stack([(ps - 1) - tb[..., 2], tb[..., 1],
                                      (ps - 1) - tb[..., 0], tb[..., 3]],
                                     -1), tb)
    return p.contiguous(), tb, tv


def gt_maps(boxes, valid, label: dict):
    """(B, M, M, 1) score, (B, M, M, 4) loc, (B, M, M, 1) ignore."""
    stride = label["stride"]
    m = label["patch_size"] // stride
    inv_norm = 1.0 / (label["std_height_px"] / stride)
    bm = boxes.float() / torch.full((), float(stride), device=boxes.device)
    x1, y1, x2, y2 = bm.unbind(-1)
    cx, cy, h = (x1 + x2) * 0.5, (y1 + y2) * 0.5, y2 - y1
    lo, hi = (float(np.float32(v * label["std_height_px"] / stride))
              for v in label["scale_band"])
    band = (h >= lo) & (h <= hi) & valid
    rc = h * label["rc_ratio"]
    rg = rc + label["rnear"]
    rc2 = torch.where(band, rc * rc, -1.0)
    rg2 = torch.where(valid, rg * rg, -1.0)
    b, k = valid.shape
    ar = torch.arange(m, dtype=torch.float32, device=boxes.device)
    px, py = ar[None, None, :], ar[None, :, None]
    best = torch.full((b, m, m), float("inf"), device=boxes.device)
    pos = torch.zeros((b, m, m), dtype=torch.bool, device=boxes.device)
    gray = torch.zeros_like(pos)
    tgt = torch.zeros((b, m, m, 4), device=boxes.device)
    corners = torch.stack([x1, y1, x2, y2], -1)
    for i in range(k):
        dx = px - cx[:, i, None, None]
        dy = py - cy[:, i, None, None]
        d2 = dx * dx + dy * dy
        pos_i = d2 <= rc2[:, i, None, None]
        gray = gray | (d2 <= rg2[:, i, None, None])
        take = pos_i & (d2 < best)
        best = torch.where(take, d2, best)
        pos = pos | pos_i
        tgt = torch.where(take[..., None], corners[:, i, None, None, :], tgt)
    pf = pos.float()
    loc = torch.stack([(px - tgt[..., 0]) * inv_norm * pf,
                       (py - tgt[..., 1]) * inv_norm * pf,
                       (tgt[..., 2] - px) * inv_norm * pf,
                       (tgt[..., 3] - py) * inv_norm * pf], -1)
    return pf[..., None], loc, (gray & ~pos).float()[..., None]


def _threshold(values, cand, n_want):
    """Per row t with count(cand & values > t) <= n_want, by 40 halvings
    from (-1, max + 1]."""
    hi = torch.where(cand, values, 0.0).amax(dim=1) + 1.0
    lo = torch.full_like(hi, -1.0)
    for _ in range(BISECT):
        mid = (lo + hi) * 0.5
        many = (cand & (values > mid[:, None])).sum(dim=1) > n_want
        lo = torch.where(many, mid, lo)
        hi = torch.where(many, hi, mid)
    return hi


def ohem(sq, pos, ign, rnd, loss: dict) -> torch.Tensor:
    """The OHEM mask (B, P) of a classification term."""
    ratio = float(np.float32(loss["neg_pos_ratio"]))
    frac = float(np.float32(loss["hard_frac"]))
    cand = ~pos & ~ign
    npos = pos.sum(dim=1)
    n_neg = torch.where(npos > 0, torch.round(npos.float() * ratio).long(),
                        torch.full_like(npos, int(loss["min_neg"])))
    n_neg = torch.minimum(n_neg, cand.sum(dim=1))
    n_hard = torch.floor(n_neg.float() * frac).long()
    t = _threshold(sq, cand, n_hard)
    above = cand & (sq > t[:, None])
    vstar = torch.where(cand & ~above, sq, float("-inf")).amax(dim=1)
    ties = cand & (sq == vstar[:, None])
    t_tie = _threshold(rnd, ties, n_hard - above.sum(dim=1))
    hard = above | (ties & (rnd > t_tie[:, None]))
    rest = cand & ~hard
    t_rand = _threshold(rnd, rest, n_neg - n_hard)
    return pos | hard | (rest & (rnd > t_rand[:, None]))


def loss_of(params: Dict[str, torch.Tensor], conf: dict, images, boxes,
            valid, draws, tf32: bool = False, rows=None
            ) -> Tuple[torch.Tensor, dict]:
    """The step's loss. ``rows`` (a control's planted fault), a (B,) bool
    mask: only those rows' terms are summed, over the whole batch's
    counts (one rank's share of a data-parallel loss)."""
    label, lcfg, model = conf["label"], conf["loss"], conf["model"]
    with torch.no_grad():
        x, tb, tv = patches(images, boxes, valid, label, draws["patches"],
                            tf32=tf32)
        score, loc, ign = gt_maps(tb, tv, label)
    keep = draws["dropout_keep"]
    rate = model["dropout_rate"]
    out = forward_float(params, model, x, dropout=(keep, 1.0 - rate),
                        tf32=tf32)
    b = x.shape[0]
    sq = ((out["score"] - score) ** 2).reshape(b, -1)
    with torch.no_grad():
        mask = ohem(sq.detach(), (score > 0.5).reshape(b, -1),
                    (ign > 0.5).reshape(b, -1), draws["ohem_score"], lcfg)
    n_s, n_l = mask.sum().double().float(), score.sum().double().float()
    if rows is not None:
        mask = mask & rows[:, None]
        score = score * rows[:, None, None, None]
    cls = (sq * mask).sum() / n_s.clamp(min=1.0)
    lsq = ((out["loc"] - loc) ** 2).sum(dim=-1, keepdim=True)
    locl = (lsq * score).sum() / n_l.clamp(min=1.0)
    return cls + lcfg["lambda_loc"] * locl, {"cls": cls, "loc": locl}


def sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
        trace: Dict[str, torch.Tensor], train: dict, step: int) -> None:
    """Clip by the global norm, add weight decay, momentum, update."""
    names = list(params)
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(grads[n]) for n in names]))
    clip = train["grad_clip_norm"]
    lr = train["learning_rate"] * train["lr_decay_rate"] ** (
        step // train["lr_decay_steps"])
    with torch.no_grad():
        for n in names:
            g = grads[n]
            if clip > 0:
                g = torch.where(norm < clip, g, g / norm * clip)
            g = g + train["weight_decay"] * params[n]
            trace[n].mul_(train["momentum"]).add_(g)
            params[n].add_(trace[n] * -lr)


def steps(weights: Dict[str, torch.Tensor], conf: dict,
          batches: List[dict], draws: List[dict], tf32: bool = False,
          rows=None, grad_scale: float = 1.0):
    """Run ``len(batches)`` steps from ``weights`` (float32; with ``tf32``
    the products in TF32, the control). Returns the losses, the momentum
    trace after the first step, the parameters after the last, and the
    gradient norms of the first step by leaf. ``rows`` (``loss_of``) and
    ``grad_scale``, the gradients' factor before the update, plant a
    control's faults."""
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in weights.items()}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_trace, grad_norms = [], None, None
    for i, (bt, dr) in enumerate(zip(batches, draws)):
        with full_f32(tf32):
            loss, _ = loss_of(params, conf, bt["image"], bt["boxes"],
                              bt["box_valid"], dr, tf32, rows)
            grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: g * grad_scale for k, g in zip(params, grads)}
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g))
                          for k, g in grads.items()}
        sgd(params, grads, trace, conf["train"], i)
        losses.append(float(loss.detach()))
        if i == 0:
            first_trace = {k: v.clone() for k, v in trace.items()}
    return losses, first_trace, {k: v.detach() for k, v in params.items()}, \
        grad_norms
