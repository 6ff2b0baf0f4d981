"""Synthetic detection data: learnable rectangles for tests and smoke runs
(port of ``densebox_tpu/data/synthetic.py``).

Bright axis-aligned rectangles over noise, with "landmarks" at the rectangle
corners. Trivially learnable: a few dozen SGD steps drive the loss down,
which is what the train-step acceptance checks assert.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.device import resolve_device

DRAWS = ("n_boxes", "ctr", "hgt", "asp", "amp", "noise")


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, device=gen.device, generator=gen) * (hi - lo) + lo


def synthetic_batch(
    generator: Optional[torch.Generator],
    batch_size: int,
    label_cfg: LabelCfg,
    max_boxes: int = 4,
    num_landmarks: int = 0,
    image_dtype: Optional[torch.dtype] = None,
    device=None,
    draws: Optional[Mapping[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """One batch of rectangle patches and padded box tensors, made on
    ``device`` (the card when none is given): ``image`` (B, P, P, 3),
    ``boxes`` (B, K, 4) xyxy px, ``box_valid`` (B, K) bool and, with
    ``num_landmarks``, ``landmarks`` (B, K, L, 2) and ``lm_valid`` (B, K, L).

    The random numbers come from ``generator`` (a ``torch.Generator`` on
    that device) or, each of them, from ``draws``: ``n_boxes`` (B,) integers
    in [1, K]; ``ctr`` (B, K, 2) in [0.25 P, 0.75 P]; ``hgt`` (B, K) in
    [0.85, 1.2] standard heights; ``asp`` (B, K) in [0.8, 1.25]; ``amp``
    (B, 1, 1) in [0.7, 1]; ``noise`` (B, P, P, 3) standard normal.
    Generation is float32; ``image_dtype`` casts the stored image once."""
    dev = resolve_device(device)
    draws = {} if draws is None else draws
    unknown = set(draws) - set(DRAWS)
    if unknown:
        raise ValueError(f"synthetic_batch: unknown draws {sorted(unknown)}")
    ps = label_cfg.patch_size
    std_h = label_cfg.std_height_px
    b, k = batch_size, max_boxes
    gen = generator

    def draw(name, make):
        if name in draws:
            return draws[name].to(dev)
        if gen is None:
            raise ValueError(f"synthetic_batch: no generator and no "
                             f"draws[{name!r}]")
        return make()

    # drawn in this order, whichever are given
    n_boxes = draw("n_boxes", lambda: torch.randint(
        1, k + 1, (b,), device=dev, generator=gen))
    ctr = draw("ctr", lambda: _uniform(gen, (b, k, 2), 0.25 * ps, 0.75 * ps))
    hgt = draw("hgt", lambda: _uniform(gen, (b, k), 0.85 * std_h, 1.2 * std_h))
    asp = draw("asp", lambda: _uniform(gen, (b, k), 0.8, 1.25))
    noise = draw("noise", lambda: torch.randn((b, ps, ps, 3), device=dev,
                                              generator=gen))
    amp = draw("amp", lambda: _uniform(gen, (b, 1, 1), 0.7, 1.0))

    box_valid = torch.arange(k, device=dev)[None, :] < n_boxes[:, None]
    wid = hgt * asp
    boxes = torch.stack([ctr[..., 0] - wid / 2, ctr[..., 1] - hgt / 2,
                         ctr[..., 0] + wid / 2, ctr[..., 1] + hgt / 2], -1)

    xs = torch.arange(ps, dtype=torch.float32, device=dev)[None, None, None, :]
    ys = torch.arange(ps, dtype=torch.float32, device=dev)[None, None, :, None]
    inside = ((xs >= boxes[..., 0, None, None])
              & (xs <= boxes[..., 2, None, None])
              & (ys >= boxes[..., 1, None, None])
              & (ys <= boxes[..., 3, None, None])
              & box_valid[..., None, None])
    fg = inside.any(dim=1).float()                               # (B, P, P)
    image = fg[..., None] * amp[..., None] + 0.15 * noise
    if image_dtype is not None:
        image = image.to(image_dtype)

    batch = {"image": image, "boxes": boxes, "box_valid": box_valid}
    if num_landmarks:
        # landmarks at the box corners (then cycling), visible when the box is
        corners = torch.stack([boxes[..., [0, 1]], boxes[..., [2, 1]],
                               boxes[..., [2, 3]], boxes[..., [0, 3]]], dim=2)
        reps = -(-num_landmarks // 4)
        batch["landmarks"] = corners.repeat(1, 1, reps, 1)[:, :, :num_landmarks]
        batch["lm_valid"] = box_valid[..., None].expand(
            b, k, num_landmarks).contiguous()
    return batch
