"""Landmark window gather: the CUDA kernel's wrapper and its plain version.

``gather_windows`` replaces ``densebox_tpu/ops/pallas/window.py:
gather_windows_pallas`` (kernel ``_kernel``): for each (image, detection,
landmark) it copies a (win, win) window out of the detection's selected
pyramid scale of the stacked heatmaps,

    out[b, d, l] = maps[b, sel[b, d], l, y0[b, d, l] : + win, x0[b, d, l] : + win]

with origins already clipped by the caller to the selected scale's map
(``infer/detector.py:decode_landmarks_selected`` clips them), as on the TPU.
Origins of shape (B, D, 1) are shared by every landmark channel (the
anchor-less decode). The copy is exact in any dtype. On a CUDA tensor the
wrapper launches ``csrc/window.cu`` (built on first use) or raises; on a CPU
tensor it runs ``gather_windows_reference``. The TPU kernel's ``dp`` knob
and its strip-geometry limits are TPU mechanics and have no counterpart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from densebox_tpu_torch.ops.kernels import build

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0

DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    global launches
    launches = 0


def gather_windows_reference(maps: torch.Tensor, sel: torch.Tensor,
                             y0: torch.Tensor, x0: torch.Tensor,
                             win: int) -> torch.Tensor:
    """Plain version: one advanced-indexing read of (B, S, L, Hm, Wm)
    ``maps`` at (B, D) ``sel`` and (B, D, L) or (B, D, 1) origins ->
    (B, D, L, win, win) in ``maps.dtype``."""
    b, _, num_lm = maps.shape[:3]
    dev = maps.device
    ar = torch.arange(win, device=dev)
    rows = (y0.long()[..., None] + ar)[..., :, None]     # (B, D, L|1, win, 1)
    cols = (x0.long()[..., None] + ar)[..., None, :]     # (B, D, L|1, 1, win)
    bi = torch.arange(b, device=dev)[:, None, None, None, None]
    si = sel.long()[:, :, None, None, None]
    li = torch.arange(num_lm, device=dev)[None, None, :, None, None]
    return maps[bi, si, li, rows, cols]


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_gather_windows`` of csrc/window.cu, built and loaded on
    first use."""
    fn = build.load("window").densebox_gather_windows
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gather_windows(maps: torch.Tensor, sel: torch.Tensor, y0: torch.Tensor,
                   x0: torch.Tensor, win: int) -> torch.Tensor:
    """(B, S, L, Hm, Wm) maps + (B, D) sel + (B, D, L) or (B, D, 1) origins
    -> (B, D, L, win, win) windows in ``maps.dtype``.

    CPU tensors take ``gather_windows_reference``. CUDA tensors launch the
    kernel: ``maps`` float32 or bfloat16, ``sel``, ``y0`` and ``x0`` int32,
    all contiguous on one device, 1 <= win <= min(Hm, Wm). Anything else
    raises, and so does a refused launch; each launch adds one to
    ``launches``."""
    if maps.device.type == "cpu":
        return gather_windows_reference(maps, sel, y0, x0, win)
    if maps.device.type != "cuda":
        raise ValueError(f"gather_windows: no kernel for device {maps.device}")
    if maps.dtype not in DTYPES:
        raise TypeError(f"gather_windows: want float32 or bfloat16 maps, "
                        f"got {maps.dtype}")
    if any(t.dtype != torch.int32 for t in (sel, y0, x0)):
        raise TypeError(f"gather_windows: want int32 sel and origins, got "
                        f"{sel.dtype}, {y0.dtype}, {x0.dtype}")
    if maps.dim() != 5 or sel.dim() != 2:
        raise ValueError(f"gather_windows: want maps (B, S, L, Hm, Wm) and "
                         f"sel (B, D), got {tuple(maps.shape)} and "
                         f"{tuple(sel.shape)}")
    b, s, num_lm, hm, wm = maps.shape
    d = sel.shape[1]
    if (sel.shape[0] != b or y0.shape != x0.shape or y0.dim() != 3
            or tuple(y0.shape[:2]) != (b, d)
            or y0.shape[2] not in (1, num_lm)):
        raise ValueError(f"gather_windows: want sel (B, D) and origins "
                         f"(B, D, L) or (B, D, 1) for maps "
                         f"{tuple(maps.shape)}, got sel {tuple(sel.shape)}, "
                         f"y0 {tuple(y0.shape)}, x0 {tuple(x0.shape)}")
    if not 1 <= win <= min(hm, wm):
        raise ValueError(f"gather_windows: want 1 <= win <= min(Hm, Wm) = "
                         f"{min(hm, wm)}, got {win}")
    if not (1 <= b * d < 2 ** 31 and s >= 1 and num_lm >= 1):
        raise ValueError(f"gather_windows: want 1 <= B*D < 2^31 and S, L "
                         f">= 1, got B={b} D={d} S={s} L={num_lm}")
    if any(t.device != maps.device for t in (sel, y0, x0)):
        raise ValueError("gather_windows: maps, sel and origins on "
                         "different devices")
    if not all(t.is_contiguous() for t in (maps, sel, y0, x0)):
        raise ValueError("gather_windows: maps, sel and origins must be "
                         "contiguous")
    out = torch.empty((b, d, num_lm, win, win), dtype=maps.dtype,
                      device=maps.device)
    with torch.cuda.device(maps.device):
        rc = _launcher()(
            maps.data_ptr(), sel.data_ptr(), y0.data_ptr(), x0.data_ptr(),
            out.data_ptr(), b, s, num_lm, hm, wm, d, y0.shape[2], win,
            maps.element_size(),
            torch.cuda.current_stream(maps.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_windows: window kernel launch failed "
                           f"with CUDA error {rc}")
    global launches
    launches += 1
    return out
