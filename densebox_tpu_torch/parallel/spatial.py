"""Spatial (halo-exchange) parallelism of the DenseBox forward (port of
``densebox_tpu/parallel/spatial.py``).

DenseBox has no attention; what outgrows one device is the image plane.
Here the image is split along H over the ranks of a process group: before
every 3x3 conv each rank receives its neighbours' edge rows (1-row halos),
the ends of the ring get zeros, which is exactly SAME padding; pooling,
space-to-depth and the 1x1 heads stay local; the align-corners x2 upsample,
which couples rows across the whole map, is made exact with per-shard
interpolation matrices over halo-extended rows. The sharded forward is
therefore the single-device forward's arithmetic, not an approximation.

Every collective is an ``all_reduce`` of a zero-filled buffer that each
rank fills with its own rows (see ``parallel/mesh.py`` for why), so it
runs over gloo and NCCL alike. Inference only.

Shards are whole blocks of ``min_divisor`` rows (what the trunk's pooling
needs), as even as the height allows: the JAX module requires
``H % (min_divisor * n) == 0``, which a pyramid level such as KITTI's
0.7071 x 384 = 272 rows does not meet for n = 4; here the first
``(H / min_divisor) % n`` ranks take one block more.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from densebox_tpu_torch.device import reference_precision
from densebox_tpu_torch.models.densebox import DenseBox, space_to_depth
from densebox_tpu_torch.ops.upsample import (
    _interp_matrix, interp_bmm, interp_matrix_align_corners)


def shard_rows(h: int, n: int, divisor: int) -> List[Tuple[int, int]]:
    """(first row, rows) of each of ``n`` shards of ``h`` rows, in whole
    blocks of ``divisor`` rows, the first ranks one block more where the
    blocks do not split evenly. Raises ``ValueError`` when ``h`` is no
    multiple of ``divisor`` or has fewer blocks than ranks."""
    if h % divisor or h // divisor < n:
        raise ValueError(f"H={h} must be a multiple of {divisor} with at "
                         f"least {n} blocks of {divisor} rows")
    base, extra = divmod(h // divisor, n)
    out, lo = [], 0
    for r in range(n):
        rows = (base + (r < extra)) * divisor
        out.append((lo, rows))
        lo += rows
    return out


def shard_upsample_matrix(h_global: int, lo: int, rows: int) -> np.ndarray:
    """(2 * rows, rows + 2) align-corners x2 row-interpolation matrix of the
    shard holding global rows lo .. lo + rows - 1 of an ``h_global``-row
    map, over its halo-extended rows (global rows lo - 1 .. lo + rows)."""
    full = interp_matrix_align_corners(h_global, 2 * h_global)
    out = np.zeros((2 * rows, rows + 2), np.float32)
    sub = full[2 * lo:2 * (lo + rows)]
    for j in range(rows + 2):
        g = lo - 1 + j
        if 0 <= g < h_global:
            out[:, j] = sub[:, g]
    return out


class _Ring:
    """The group's ranks in image order, and this rank's place."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def halo(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Hl, W, C) -> (B, Hl + 2, W, C): the last row of the shard
        above and the first row of the shard below (zeros at the image's
        top and bottom)."""
        b, _, w, c = x.shape
        buf = torch.zeros((self.n, 2, b, w, c), device=x.device,
                          dtype=torch.float32)
        buf[self.rank, 0] = x[:, 0]
        buf[self.rank, 1] = x[:, -1]
        dist.all_reduce(buf, group=self.group)
        zero = buf.new_zeros((b, w, c))
        above = buf[self.rank - 1, 1] if self.rank > 0 else zero
        below = buf[self.rank + 1, 0] if self.rank < self.n - 1 else zero
        return torch.cat([above[:, None].to(x.dtype), x,
                          below[:, None].to(x.dtype)], dim=1)

    def gather_rows(self, x: torch.Tensor, h: int, lo: int) -> torch.Tensor:
        """This shard's rows (B, Hl, W, C) at ``lo`` -> the whole (B, h, W,
        C) map, on every rank."""
        buf = x.new_zeros((x.shape[0], h) + tuple(x.shape[2:]))
        buf[:, lo:lo + x.shape[1]] = x
        dist.all_reduce(buf, group=self.group)
        return buf


def _conv_halo(ring: _Ring, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv + bias of a channels_last NCHW shard, its rows
    extended by the neighbours' halos (the conv pads W only)."""
    xe = ring.halo(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    return F.conv2d(xe, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=(0, 1))


@torch.no_grad()
def spatial_forward(model: DenseBox, images: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> Dict[str, torch.Tensor]:
    """``model``'s eval forward of the (B, H, W, 3) images (the same on
    every rank) with H split over the ranks of ``group`` (the default
    group when None), in rank order. Returns the same dict of stride-4
    NHWC float32 maps as ``model(images)``, whole, on every rank.

    H must be a multiple of ``cfg.min_divisor`` with at least one block of
    it per rank (``shard_rows``); W as for the model. At the model's
    precision, as its forward (``device.reference_precision``)."""
    with reference_precision(model.cfg.compute_dtype):
        return _spatial_forward(model, images, group)


def _spatial_forward(model: DenseBox, images: torch.Tensor,
                     group: Optional[dist.ProcessGroup]
                     ) -> Dict[str, torch.Tensor]:
    ring = _Ring(group)
    cfg = model.cfg
    b, h, w, _ = images.shape
    if w % cfg.min_divisor:
        raise ValueError(f"W={w} must be divisible by {cfg.min_divisor}")
    lo, rows = shard_rows(h, ring.n, cfg.min_divisor)[ring.rank]
    # the shard's rows at stride 8, the trunk's output stride for every stem
    lo8, rows8, h8 = lo // 8, rows // 8, h // 8
    dtype = getattr(torch, cfg.compute_dtype)
    dev = images.device

    x = images[:, lo:lo + rows].to(dtype).permute(0, 3, 1, 2)
    f3 = None
    for kind, name, _ in model.plan:
        if kind == "conv":
            x = torch.relu(_conv_halo(ring, getattr(model, name), x))
            if name == model.f3_tap:
                f3 = x
        elif kind in ("s2d", "s2d4"):
            r = 2 if kind == "s2d" else 4
            x = space_to_depth(x.permute(0, 2, 3, 1), r).permute(0, 3, 1, 2)
        else:
            x = F.max_pool2d(x, 2, 2)

    # exact x2 align-corners upsample across the shard boundaries: W as the
    # model does it, then H through this shard's matrix over its halo rows
    f4e = ring.halo(x.permute(0, 2, 3, 1))          # (B, rows8 + 2, W8, C)
    _, he, w8, c = f4e.shape
    aw = _interp_matrix(w8, 2 * w8, dev, dtype)
    y = interp_bmm(aw, f4e.reshape(b * he, w8, c))
    ah = torch.from_numpy(shard_upsample_matrix(h8, lo8, rows8)).to(dev, dtype)
    y = interp_bmm(ah, y.reshape(b, he, 2 * w8 * c))
    up = y.reshape(b, 2 * rows8, 2 * w8, c)

    z = model._heads(f3, up, False, None, None)     # (B, rows/4, W/4, n)
    score, loc = z[..., 0:1], z[..., 1:5]
    maps = [score.float(), loc.float()]
    names = ["score", "loc"]
    if cfg.num_landmarks:
        lm = z[..., 5:5 + cfg.num_landmarks]
        maps.append(lm.float())
        names.append("lm")
        if cfg.use_refine:
            r = torch.cat([score, lm], dim=-1).permute(0, 3, 1, 2)
            r = torch.relu(_conv_halo(ring, model.refine_conv1, r))
            r = torch.relu(_conv_halo(ring, model.refine_conv2, r))
            maps.append(model._conv(model.refine_out, r).permute(
                0, 2, 3, 1).float())
            names.append("refined")
    widths = [t.shape[-1] for t in maps]
    whole = ring.gather_rows(torch.cat(maps, dim=-1), h // 4, lo // 4)
    return dict(zip(names, whole.split(widths, dim=-1)))


class SpatialDenseBox(nn.Module):
    """``model`` behind ``spatial_forward``: called like the model, it
    returns the whole head maps on every rank, so ``infer.detect_batch`` /
    ``make_detect_fn`` (decode, cap, NMS, landmark decode) run on them
    unchanged on each rank. Every rank of ``group`` must make the same
    calls. Inference only."""

    def __init__(self, model: DenseBox,
                 group: Optional[dist.ProcessGroup] = None):
        super().__init__()
        self.model = model
        self.group = group
        self.cfg = model.cfg

    def forward(self, images: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        if train:
            raise ValueError("SpatialDenseBox is inference only")
        return spatial_forward(self.model, images, self.group)
