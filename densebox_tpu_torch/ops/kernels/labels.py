"""GT rasterizers: the two CUDA kernels' wrappers and their plain versions.

``rasterize_boxes`` and ``rasterize_landmarks`` replace the two kernels of
``densebox_tpu/ops/pallas/labels.py`` (``_kernel`` and ``_lm_kernel``, both
behind ``rasterize_batch_pallas``). They take the packed rows that
``pack_boxes`` / ``pack_landmarks`` make in plain torch (as the TPU kernels
take the rows ``_pack_boxes`` makes outside the kernel) and write the maps
in the NHWC layout the loss reads:

  rasterize_boxes(rows (B, K, 8), m, inv_norm)
      rows = [cx, cy, rc2, rg2, x1, y1, x2, y2] in map units; rc2 < 0 for a
      box that is invalid or out of the scale band, rg2 < 0 for an invalid
      one. Per pixel (x, y) and box, d2 = (x-cx)^2 + (y-cy)^2:
        score  (B, M, M, 1)  1 where any d2 <= rc2
        ignore (B, M, M, 1)  1 where any d2 <= rg2 and score is 0
        loc    (B, M, M, 4)  (x-x1, y-y1, x2-x, y2-y) * inv_norm * score of
                             the positive box with the smallest d2 (the
                             lowest index among equals)
  rasterize_landmarks(rows (B, K*L, 3), m, num_lm)
      rows = [lx, ly, r2] (row i*L + l: box i, landmark l; r2 < 0 when the
      landmark is invisible or its box out of band):
        lm     (B, M, M, L)  1 where any box's (x-lx)^2 + (y-ly)^2 <= r2

  rasterize_maps(rows, lm_rows, m, inv_norm, num_lm)
      both of the above for one batch: on the card one launch for the two
      maps (it adds one to each kernel's count).

Every float operation is rounded on its own (no FMA), in the kernels and in
the plain versions, so both equal the JAX functions called without jit bit
for bit. On a CUDA tensor a wrapper launches ``csrc/labels.cu`` (built on
first use) or raises; on a CPU tensor it runs the plain version.

The landmark kernel scatters: a block owns ``landmark_chunk`` floats of a
patch's flattened (M, M, L) output and tests, for each row with r2 >= 0,
only the pixels around its disc. The box kernel keeps, in index order, only
the rows that can touch a block's tile of 32 x 8 pixels. Numpy models of
both schedules are held to the plain versions in tests/test_torch_labels.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.ops.decode import div
from densebox_tpu_torch.ops.kernels import build

LM_RADIUS = 1.0  # map units (paper §4: "radius ~1 px")

# Kernel launches since the last reset, per kernel; only the launch sites add.
launches = {"rasterize_boxes": 0, "rasterize_landmarks": 0}

MAX_ROWS = 1024      # rows of one patch staged in shared memory
LM_MAX_CHUNK = 6140  # floats of landmark output a block builds there (24 KB)
LM_MIN_CHUNK = 1024  # and the least it is given, however small the batch
LM_BLOCKS = 320      # blocks the landmark kernel aims at over a batch


def landmark_chunk(m: int, num_lm: int, batch: int) -> Tuple[int, int]:
    """(floats of a patch's (M, M, L) output that one block of the landmark
    kernel builds, blocks per patch): about ``LM_BLOCKS`` blocks over the
    batch (timed on an H100 at B = 32: 3 to 20 blocks a patch, flat from 8
    to 15), within what shared memory holds, a multiple of 4 floats (the
    16-byte stores)."""
    per = m * m * num_lm
    blocks = max(-(-LM_BLOCKS // batch), -(-per // LM_MAX_CHUNK))
    chunk = max(-(-per // blocks), min(LM_MIN_CHUNK, per))
    chunk = min(-(-chunk // 4) * 4, LM_MAX_CHUNK)
    return chunk, -(-per // chunk)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _in_band(h: torch.Tensor, box_valid: torch.Tensor, cfg: LabelCfg
             ) -> torch.Tensor:
    # the band's ends rounded to float32 first, as JAX rounds a Python
    # scalar that meets a float32 array
    lo, hi = (float(np.float32(v)) for v in cfg.height_band_map)
    return (h >= lo) & (h <= hi) & box_valid


def pack_boxes(boxes: torch.Tensor, box_valid: torch.Tensor, cfg: LabelCfg
               ) -> torch.Tensor:
    """(B, K, 4) xyxy px boxes and (B, K) bool validity -> (B, K, 8)
    float32 kernel rows (see the module docstring)."""
    bm = div(boxes.float(), cfg.stride)
    x1, y1, x2, y2 = bm.unbind(-1)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    h = y2 - y1
    rc = h * cfg.rc_ratio
    rg = rc + cfg.rnear
    rc2 = torch.where(_in_band(h, box_valid, cfg), rc * rc, -1.0)
    rg2 = torch.where(box_valid, rg * rg, -1.0)
    return torch.stack([cx, cy, rc2, rg2, x1, y1, x2, y2], dim=-1)


def pack_landmarks(boxes: torch.Tensor, box_valid: torch.Tensor,
                   landmarks: torch.Tensor, lm_valid: torch.Tensor,
                   cfg: LabelCfg) -> torch.Tensor:
    """(B, K, L, 2) xy px landmarks with (B, K, L) bool visibility, of the
    (B, K, 4) boxes -> (B, K*L, 3) float32 kernel rows."""
    b, k, num_lm, _ = landmarks.shape
    lmm = div(landmarks.float(), cfg.stride)
    h = div(boxes[..., 3].float() - boxes[..., 1].float(), cfg.stride)
    ok = lm_valid & _in_band(h, box_valid, cfg)[..., None]
    r2 = torch.where(ok, LM_RADIUS * LM_RADIUS, -1.0)
    return torch.cat([lmm, r2[..., None]], dim=-1).reshape(b, k * num_lm, 3)


def _grid(m: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    ar = torch.arange(m, dtype=torch.float32, device=device)
    return ar[None, None, :], ar[None, :, None]      # x (1, 1, M), y (1, M, 1)


def rasterize_boxes_reference(rows: torch.Tensor, m: int, inv_norm: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of ``rasterize_boxes``: the boxes in index order over
    running (B, M, M) maps, one torch operation per float operation."""
    b, k, _ = rows.shape
    px, py = _grid(m, rows.device)
    best_d2 = torch.full((b, m, m), float("inf"), device=rows.device)
    pos = torch.zeros((b, m, m), dtype=torch.bool, device=rows.device)
    gray = torch.zeros_like(pos)
    best_box = torch.zeros((b, m, m, 4), device=rows.device)
    for i in range(k):
        row = rows[:, i, :, None, None]              # (B, 8, 1, 1)
        dx = px - row[:, 0]
        dy = py - row[:, 1]
        d2 = dx * dx + dy * dy
        pos_i = d2 <= row[:, 2]
        gray = gray | (d2 <= row[:, 3])
        take = pos_i & (d2 < best_d2)
        best_d2 = torch.where(take, d2, best_d2)
        pos = pos | pos_i
        best_box = torch.where(take[..., None], rows[:, i, None, None, 4:],
                               best_box)
    posf = pos.float()
    loc = torch.stack([(px - best_box[..., 0]) * inv_norm * posf,
                       (py - best_box[..., 1]) * inv_norm * posf,
                       (best_box[..., 2] - px) * inv_norm * posf,
                       (best_box[..., 3] - py) * inv_norm * posf], dim=-1)
    return posf[..., None], loc, (gray & ~pos).float()[..., None]


def rasterize_landmarks_reference(rows: torch.Tensor, m: int, num_lm: int
                                  ) -> torch.Tensor:
    """Plain version of ``rasterize_landmarks``: (B, K*L, 3) rows ->
    (B, M, M, L) float32."""
    b = rows.shape[0]
    r = rows.reshape(b, -1, num_lm, 3)[..., None, None]    # (B, K, L, 3, 1, 1)
    px, py = _grid(m, rows.device)
    dx = px - r[..., 0, :, :]                              # (B, K, L, 1, M)
    dy = py - r[..., 1, :, :]                              # (B, K, L, M, 1)
    hit = (dx * dx + dy * dy <= r[..., 2, :, :]).any(dim=1)     # (B, L, M, M)
    return hit.permute(0, 2, 3, 1).float().contiguous()


@functools.lru_cache(maxsize=None)
def _launchers():
    """The three entry points of csrc/labels.cu (boxes, landmarks, both),
    built and loaded on first use."""
    lib = build.load("labels")
    boxes = lib.densebox_rasterize_boxes
    boxes.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_float, ctypes.c_void_p])
    lms = lib.densebox_rasterize_landmarks
    lms.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    both = lib.densebox_rasterize_maps
    both.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    boxes.restype = lms.restype = both.restype = ctypes.c_int
    return boxes, lms, both


def _check_rows(name: str, rows: torch.Tensor, width: int, m: int) -> None:
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if rows.dtype != torch.float32:
        raise TypeError(f"{name}: want float32 rows, got {rows.dtype}")
    if rows.dim() != 3 or rows.shape[2] != width:
        raise ValueError(f"{name}: want rows (B, N, {width}), got "
                         f"{tuple(rows.shape)}")
    if not (rows.shape[0] >= 1 and 1 <= rows.shape[1] <= MAX_ROWS):
        raise ValueError(f"{name}: want B >= 1 and 1 <= rows per patch <= "
                         f"{MAX_ROWS}, got {tuple(rows.shape)}")
    if not 1 <= m <= 4096:
        raise ValueError(f"{name}: want 1 <= map size <= 4096, got {m}")
    if not rows.is_contiguous():
        raise ValueError(f"{name}: rows must be contiguous")


def _box_outputs(rows: torch.Tensor, m: int):
    b = rows.shape[0]
    score = torch.empty((b, m, m, 1), dtype=torch.float32, device=rows.device)
    loc = torch.empty((b, m, m, 4), dtype=torch.float32, device=rows.device)
    return score, loc, torch.empty_like(score)


def _check_landmark_rows(rows: torch.Tensor, num_lm: int) -> None:
    if num_lm < 1 or rows.dim() != 3 or rows.shape[1] % num_lm:
        raise ValueError(f"rasterize_landmarks: want rows (B, K*L, 3) with "
                         f"L = {num_lm} >= 1, got {tuple(rows.shape)}")


def rasterize_boxes(rows: torch.Tensor, m: int, inv_norm: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, K, 8) float32 rows -> score (B, M, M, 1), loc (B, M, M, 4),
    ignore (B, M, M, 1), float32. ``inv_norm`` is rounded to float32 once.

    CPU rows take ``rasterize_boxes_reference``. CUDA rows (float32,
    contiguous, 1 <= K <= 1024) launch the kernel; anything else raises, and
    so does a refused launch. Each launch adds one to
    ``launches["rasterize_boxes"]``."""
    inv_norm = float(np.float32(inv_norm))
    if rows.device.type == "cpu":
        return rasterize_boxes_reference(rows, m, inv_norm)
    _check_rows("rasterize_boxes", rows, 8, m)
    b, k, _ = rows.shape
    score, loc, ignore = _box_outputs(rows, m)
    with torch.cuda.device(rows.device):
        rc = _launchers()[0](
            rows.data_ptr(), score.data_ptr(), loc.data_ptr(),
            ignore.data_ptr(), b, k, m, inv_norm,
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_boxes: kernel launch failed with "
                           f"CUDA error {rc}")
    launches["rasterize_boxes"] += 1
    return score, loc, ignore


def rasterize_landmarks(rows: torch.Tensor, m: int, num_lm: int
                        ) -> torch.Tensor:
    """(B, K*L, 3) float32 rows -> (B, M, M, L) float32 landmark discs.

    CPU rows take ``rasterize_landmarks_reference``. CUDA rows (float32,
    contiguous, 1 <= K*L <= 1024, a multiple of L) launch the kernel;
    anything else raises, and so does a refused launch. Each launch adds one
    to ``launches["rasterize_landmarks"]``."""
    _check_landmark_rows(rows, num_lm)
    if rows.device.type == "cpu":
        return rasterize_landmarks_reference(rows, m, num_lm)
    _check_rows("rasterize_landmarks", rows, 3, m)
    b = rows.shape[0]
    lm = torch.empty((b, m, m, num_lm), dtype=torch.float32,
                     device=rows.device)
    with torch.cuda.device(rows.device):
        rc = _launchers()[1](
            rows.data_ptr(), lm.data_ptr(), b, rows.shape[1] // num_lm,
            num_lm, m, landmark_chunk(m, num_lm, b)[0],
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_landmarks: kernel launch failed with "
                           f"CUDA error {rc}")
    launches["rasterize_landmarks"] += 1
    return lm


def rasterize_maps(rows: torch.Tensor, lm_rows: torch.Tensor, m: int,
                   inv_norm: float, num_lm: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """``rasterize_boxes(rows, m, inv_norm)`` and
    ``rasterize_landmarks(lm_rows, m, num_lm)`` of one batch (rows (B, K, 8),
    lm_rows (B, K*L, 3), both on one device) -> score, loc, ignore, lm.

    CPU rows take the two plain versions. CUDA rows launch both kernels'
    work as one grid; what either wrapper refuses raises here too. Each
    launch adds one to ``launches["rasterize_boxes"]`` and one to
    ``launches["rasterize_landmarks"]``."""
    inv_norm = float(np.float32(inv_norm))
    _check_landmark_rows(lm_rows, num_lm)
    if (lm_rows.device != rows.device or lm_rows.shape[0] != rows.shape[0]
            or rows.dim() != 3
            or lm_rows.shape[1] != rows.shape[1] * num_lm):
        raise ValueError(f"rasterize_maps: want rows (B, K, 8) and lm_rows "
                         f"(B, K*{num_lm}, 3) on one device, got "
                         f"{tuple(rows.shape)} on {rows.device} and "
                         f"{tuple(lm_rows.shape)} on {lm_rows.device}")
    if rows.device.type == "cpu":
        return rasterize_boxes_reference(rows, m, inv_norm) + (
            rasterize_landmarks_reference(lm_rows, m, num_lm),)
    _check_rows("rasterize_maps", rows, 8, m)
    _check_rows("rasterize_maps", lm_rows, 3, m)
    b, k, _ = rows.shape
    score, loc, ignore = _box_outputs(rows, m)
    lm = torch.empty((b, m, m, num_lm), dtype=torch.float32,
                     device=rows.device)
    with torch.cuda.device(rows.device):
        rc = _launchers()[2](
            rows.data_ptr(), score.data_ptr(), loc.data_ptr(),
            ignore.data_ptr(), lm_rows.data_ptr(), lm.data_ptr(), b, k,
            num_lm, m, inv_norm, landmark_chunk(m, num_lm, b)[0],
            torch.cuda.current_stream(rows.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rasterize_maps: kernel launch failed with CUDA "
                           f"error {rc}")
    launches["rasterize_boxes"] += 1
    launches["rasterize_landmarks"] += 1
    return score, loc, ignore, lm
