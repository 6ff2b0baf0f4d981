"""On-device patch sampling and augmentation (port of
``densebox_tpu/data/patches.py``; paper §3.1, §3.4).

The host only pads full images onto a fixed canvas; anchor choice, scale and
translation jitter, horizontal flip, crop + resize and the box transform
happen on the device in one batched function.

Sampling:
  * positive patch: centred on a random valid anchor box (translation
    jittered), the window sized so that the anchor's height lands at
    std_height_px * u, u ~ U[scale_band], after the resize to patch_size;
  * negative patch: a random window (no anchor), mixed in at ``neg_frac``
    and taken for images without boxes;
  * a box keeps its label if its centre stays inside the window.

The crop is ``jax.image.scale_and_translate(..., "linear")`` written out:
per-sample triangle-filter weight matrices (``infer/resize.py:
weight_matrices``, antialiased when the window is larger than the patch)
applied as two products.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.infer.resize import weight_matrices
from densebox_tpu_torch.ops.decode import rdiv

DRAWS = ("anchor", "scale", "trans", "neg_size", "neg_pos", "neg", "flip")


def patch_draws(generator: Optional[torch.Generator], b: int, k: int,
                cfg: LabelCfg, device, *, max_translate_frac: float = 0.25,
                hflip: bool = True,
                given: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """The random numbers ``sample_patches`` takes for a batch of ``b``
    images with ``k`` box slots, each from ``given`` or else drawn from
    ``generator`` in the order of ``DRAWS`` (see ``sample_patches`` for
    their ranges). A data-parallel step draws them for the global batch and
    keeps its own rows (``parallel/mesh.py``)."""
    given = {} if given is None else given
    unknown = set(given) - set(DRAWS)
    if unknown:
        raise ValueError(f"sample_patches: unknown draws {sorted(unknown)}")
    lo, hi = cfg.scale_band
    specs = [("anchor", (b, k), 0.0, 1.0), ("scale", (b,), lo, hi),
             ("trans", (b, 2), -max_translate_frac, max_translate_frac),
             ("neg_size", (b,), 0.5, 2.0), ("neg_pos", (b, 2), 0.0, 1.0),
             ("neg", (b,), 0.0, 1.0)]
    if hflip:
        specs.append(("flip", (b,), 0.0, 1.0))
    out = {}
    for name, shape, lo, hi in specs:
        if name in given:
            out[name] = given[name].to(device)
        elif generator is None:
            raise ValueError(f"sample_patches: no generator and no "
                             f"draws[{name!r}]")
        else:
            out[name] = torch.rand(shape, device=device,
                                   generator=generator) * (hi - lo) + lo
    return out


def sample_patches(
    generator: Optional[torch.Generator],
    images: torch.Tensor,       # (B, Hc, Wc, C) canvas-padded full images
    boxes: torch.Tensor,        # (B, K, 4) xyxy canvas coords (padded)
    box_valid: torch.Tensor,    # (B, K) bool
    cfg: LabelCfg,
    *,
    neg_frac: float = 0.3,
    max_translate_frac: float = 0.25,
    hflip: bool = True,
    landmarks: Optional[torch.Tensor] = None,   # (B, K, L, 2)
    lm_valid: Optional[torch.Tensor] = None,    # (B, K, L) bool
    crop_dtype: Optional[torch.dtype] = None,   # interpolation dtype; None
                                                # keeps the images' dtype
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Full images -> a train-step batch (``image``, ``boxes``,
    ``box_valid`` [, ``landmarks``, ``lm_valid``] and ``flipped``) with
    coordinates in patch pixels, on the images' device.

    The random numbers come from ``generator`` (on that device) or, each of
    them, from ``draws``: ``anchor`` (B, K) in [0, 1); ``scale`` (B,) in
    ``cfg.scale_band``; ``trans`` (B, 2) in [-max_translate_frac,
    max_translate_frac]; ``neg_size`` (B,) in [0.5, 2] patch sizes;
    ``neg_pos`` (B, 2), ``neg`` (B,) and ``flip`` (B,) in [0, 1)."""
    dev = images.device
    b, hc, wc, _ = images.shape
    k = boxes.shape[1]
    ps = float(cfg.patch_size)
    d = patch_draws(generator, b, k, cfg, dev,
                    max_translate_frac=max_translate_frac, hflip=hflip,
                    given=draws)

    # --- anchor choice: a random valid box per sample -----------------------
    rnd = d["anchor"]
    anchor_idx = torch.where(box_valid, rnd, -1.0).argmax(dim=1)      # (B,)
    has_box = box_valid.any(dim=1)
    abox = torch.gather(boxes, 1, anchor_idx[:, None, None].expand(b, 1, 4))[:, 0]
    a_h = (abox[:, 3] - abox[:, 1]).clamp(min=1.0)
    a_cx = (abox[:, 0] + abox[:, 2]) * 0.5
    a_cy = (abox[:, 1] + abox[:, 3]) * 0.5

    # --- window geometry ----------------------------------------------------
    u = d["scale"]
    # window size so that after the resize the anchor height is std_height*u
    win = a_h * ps / (u * cfg.std_height_px)
    jit_xy = d["trans"] * win[:, None]
    wx = a_cx + jit_xy[:, 0] - win * 0.5
    wy = a_cy + jit_xy[:, 1] - win * 0.5

    # negative window: random size and position anywhere on the canvas
    neg_size = d["neg_size"] * ps
    neg_u = d["neg_pos"]
    neg_xy = torch.stack([neg_u[:, 0] * (float(wc) - neg_size),
                          neg_u[:, 1] * (float(hc) - neg_size)], dim=-1)
    is_neg = (d["neg"] < float(np.float32(neg_frac))) | ~has_box
    win = torch.where(is_neg, neg_size, win)
    wx = torch.where(is_neg, neg_xy[:, 0], wx)
    wy = torch.where(is_neg, neg_xy[:, 1], wy)

    # --- crop + resize on device -------------------------------------------
    scale = rdiv(ps, win)                                             # (B,)
    if crop_dtype is not None:
        images = images.to(crop_dtype)
    wh = weight_matrices(hc, cfg.patch_size, scale, -wy * scale)
    ww = weight_matrices(wc, cfg.patch_size, scale, -wx * scale)
    patches = torch.einsum("bho,bhwc->bowc", wh.to(images.dtype), images)
    patches = torch.einsum("bwp,bowc->bopc", ww.to(images.dtype), patches)

    # --- transform boxes ----------------------------------------------------
    off = torch.stack([wx, wy, wx, wy], dim=-1)[:, None]              # (B,1,4)
    tb = (boxes - off) * scale[:, None, None]
    cx = (tb[..., 0] + tb[..., 2]) * 0.5
    cy = (tb[..., 1] + tb[..., 3]) * 0.5
    tv = box_valid & (cx >= 0) & (cx < ps) & (cy >= 0) & (cy < ps)

    out: Dict[str, torch.Tensor] = {}
    if hflip:
        flip = d["flip"] < 0.5
        fm = flip[:, None, None]
        patches = torch.where(fm[..., None], patches.flip(2), patches)
        tb = torch.where(
            fm, torch.stack([(ps - 1) - tb[..., 2], tb[..., 1],
                             (ps - 1) - tb[..., 0], tb[..., 3]], dim=-1), tb)
        out["flipped"] = flip
    out.update(image=patches.contiguous(), boxes=tb, box_valid=tv)

    if landmarks is not None:
        lm = (landmarks - torch.stack([wx, wy], dim=-1)[:, None, None]) \
            * scale[:, None, None, None]
        lv = (lm_valid.expand(lm.shape[:3]) if lm_valid is not None
              else torch.ones(lm.shape[:3], dtype=torch.bool, device=dev))
        if hflip:
            flipped_lm = torch.stack([(ps - 1) - lm[..., 0], lm[..., 1]], dim=-1)
            # channel identities swap under a mirror (cfg.lm_flip_perm):
            # left and right landmarks trade places, not only coordinates
            if cfg.lm_flip_perm is not None:
                perm = list(cfg.lm_flip_perm)
                flipped_lm = flipped_lm[:, :, perm, :]
                lv = torch.where(flip[:, None, None], lv[:, :, perm], lv)
            lm = torch.where(flip[:, None, None, None], flipped_lm, lm)
        out["landmarks"] = lm
        out["lm_valid"] = tv[..., None] & lv
    return out
