"""Seeded synthetic scenes, made on the device in bulk: noise over a
shaded background with solid objects of a kind's sizes and shapes, after
``densebox_tpu_torch/data/synthetic.py``'s rectangles over noise.

Kinds (a mix names one): ``vehicles`` (wide boxes, 24-160 px high, as
KITTI's cars at 480 x 640) and ``faces`` (near-square boxes, 24-120 px,
with five dark landmark dots at the canonical eye, nose and mouth
positions). Pixel (0, 0, channel 0) of scene i holds (i + 1) / 1024 so that
a canvas can be told apart from a zero pad slot and traced to its scene.
"""

from __future__ import annotations

import torch

KINDS = {
    "vehicles": dict(height=(24.0, 160.0), aspect=(1.3, 2.6), dots=()),
    "faces": dict(height=(24.0, 120.0), aspect=(0.75, 0.95),
                  dots=((0.30, 0.38), (0.70, 0.38), (0.50, 0.55),
                        (0.35, 0.75), (0.65, 0.75))),
}


def fingerprint(canvas) -> int:
    """The scene index a canvas (H, W, 3) carries, or -1 for a blank."""
    return int(round(float(canvas[0, 0, 0]) * 1024)) - 1


def _paint(img, boxes, valid, dots, col, ys, xs):
    """Objects (m, K, 4) xyxy onto (m, H, W, 3) images, where valid."""
    for j in range(boxes.shape[1]):
        x1, y1, x2, y2 = (boxes[:, j, i, None, None] for i in range(4))
        inside = ((xs >= x1) & (xs <= x2) & (ys >= y1) & (ys <= y2)
                  & valid[:, j, None, None])
        img = torch.where(inside[..., None], col[:, j, None, None, :], img)
        r2 = (0.07 * (y2 - y1)) ** 2
        for ax, ay in dots:
            dx = xs - (x1 + ax * (x2 - x1))
            dy = ys - (y1 + ay * (y2 - y1))
            dot = ((dx * dx + dy * dy) <= r2) & valid[:, j, None, None]
            img = torch.where(dot[..., None], 0.05, img)
    return img


def scenes(n: int, hw, kind: str, objects: int, generator: torch.Generator,
           chunk: int = 16, height=None, any_count: bool = False):
    """(n, H, W, 3) float32 scenes in [0, 1] on the generator's device,
    with their objects' boxes (n, objects, 4) xyxy in pixels and which are
    present (n, objects): all of them, or with ``any_count`` a count in
    [1, objects] per scene. ``height`` overrides the kind's range of
    object heights."""
    spec = KINDS[kind]
    dev = generator.device
    h, w = hw
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=dev)
    boxes = torch.empty((n, objects, 4), dtype=torch.float32, device=dev)
    valid = torch.ones((n, objects), dtype=torch.bool, device=dev)
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :]

    def uni(shape, lo, hi):
        return torch.rand(shape, device=dev, generator=generator) \
            * (hi - lo) + lo

    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        base = uni((m, 1, 1, 3), 0.15, 0.55)
        tilt = uni((m, 1, 1, 1), -0.2, 0.2) * (ys[..., None] / h - 0.5)
        img = base + tilt + 0.08 * torch.randn((m, h, w, 3), device=dev,
                                               generator=generator)
        hgt = uni((m, objects), *(height or spec["height"]))
        wid = hgt * uni((m, objects), *spec["aspect"])
        cx = uni((m, objects), 0.0, 1.0) * w
        cy = uni((m, objects), 0.0, 1.0) * h
        col = uni((m, objects, 3), 0.45, 1.0)
        bx = torch.stack([cx - wid / 2, cy - hgt / 2, cx + wid / 2,
                          cy + hgt / 2], dim=-1)
        if any_count:
            count = torch.randint(1, objects + 1, (m,), device=dev,
                                  generator=generator)
            valid[s:s + m] = torch.arange(objects, device=dev) < count[:, None]
        out[s:s + m] = _paint(img, bx, valid[s:s + m], spec["dots"], col,
                              ys, xs).clamp(0.0, 1.0)
        boxes[s:s + m] = bx
    return out, boxes, valid


def scene_pool(n: int, hw, kind: str, objects: int, generator: torch.Generator,
               chunk: int = 16) -> torch.Tensor:
    """(n, H, W, 3) scenes (``scenes``), pixel (0, 0, 0) of scene i set to
    (i + 1) / 1024."""
    out = scenes(n, hw, kind, objects, generator, chunk)[0]
    idx = torch.arange(n, device=out.device, dtype=torch.float32)
    out[:, 0, 0, 0] = (idx + 1) / 1024
    return out
