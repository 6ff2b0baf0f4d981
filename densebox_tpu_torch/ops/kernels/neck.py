"""Int8 neck of the fused int8 chain: the CUDA kernel's wrapper and its plain
version.

``int8_neck`` joins ``QuantDenseBox``'s int8 trunk to its int8 heads, at one
pyramid scale: from the f3 codes (B, H, W, C3) int8 at ``f3_scale`` (the
input scale of conv4_1) and conv4_4's float32 output f4 (B, H/2, W/2, C4),
it writes the codes (B, H, W, C3 + C4) int8 at ``out_scale`` (the heads'
conv1 input scale) that the heads' first convs read. Step by step, as the
JAX package's ``_forward_fused`` (``densebox_tpu/models/quant.py``) runs
them: f4 rounded to bfloat16; f3 dequantised and rounded to bfloat16; the x2
align-corners upsample of f4 (``upsample2x_align_corners``: W, then H, each
output the float32 sum of two exact products rounded to bfloat16); the
concat, f3 first; and ``quant_act``'s quantise, a true division. No TPU
kernel is replaced: XLA fused these steps on the TPU.

The wrapper calls the custom operator ``densebox::int8_neck``: on a CUDA
tensor it launches ``csrc/neck.cu`` (built on first use) or raises; on a
CPU tensor it runs ``neck_reference``, the eager sequence itself; under
``torch.export`` it is one node whose fake rule gives the output. The
kernel takes the upsample's taps from ``interp_taps``, tables made once per
shape and device from the same matrices.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from densebox_tpu_torch.ops.int8 import GLUE, quant_act
from densebox_tpu_torch.ops.kernels import build
from densebox_tpu_torch.ops.upsample import (interp_matrix_align_corners,
                                             upsample2x_align_corners)
from densebox_tpu_torch.utils.constants import constant_cache

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0
ALIGNMENT = 16      # bytes, of every tensor the kernel reads or writes


def reset_launches() -> None:
    global launches
    launches = 0


def neck_reference(f3_q: torch.Tensor, f4: torch.Tensor,
                   f3_scale: torch.Tensor, out_scale: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``int8_neck``, on either device: the eager sequence
    of ``_forward_fused``."""
    f4 = f4.to(GLUE)                # the last trunk conv emitted f32
    f3 = (f3_q.to(torch.float32) * f3_scale).to(GLUE)
    feat = torch.cat([f3, upsample2x_align_corners(f4)], dim=-1)
    return quant_act(feat, out_scale)


@constant_cache
def interp_taps(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """The two taps of each row of ``interp_matrix_align_corners(n_in,
    n_out)`` in bfloat16, as the upsample's products read them: (3, n_out)
    int32 of the first input index ``lo`` and the bits of the float32
    weights of inputs ``lo`` and ``lo + 1`` (``lo + 1`` is ``lo`` and its
    weight 0 where ``n_in`` is 1). Made once per shape and device; raises
    if a row had a third nonzero."""
    m = torch.from_numpy(interp_matrix_align_corners(n_in, n_out)).to(
        torch.bfloat16).float()
    rows = torch.arange(n_out)
    lo = (m != 0).int().argmax(dim=1).clamp(max=max(n_in - 2, 0))
    hi = (lo + 1).clamp(max=n_in - 1)
    wa = m[rows, lo]
    wb = torch.where(hi > lo, m[rows, hi], torch.zeros(()))
    back = torch.zeros_like(m)
    back[rows, lo] = wa
    back[rows, hi] += wb
    if not torch.equal(back, m):
        raise ValueError(f"interp_taps: a row of the ({n_out}, {n_in}) "
                         f"matrix has more than two taps")
    return torch.stack([lo.int(), wa.view(torch.int32),
                        wb.view(torch.int32)]).to(device)


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_neck`` of csrc/neck.cu, built and loaded on first use."""
    fn = build.load("neck").densebox_neck
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.library.custom_op(
    "densebox::int8_neck", mutates_args=(), device_types="cpu",
    schema="(Tensor f3_q, Tensor f4, Tensor f3_scale, Tensor out_scale) "
           "-> Tensor")
def _neck_op(f3_q, f4, f3_scale, out_scale):
    return neck_reference(f3_q, f4, f3_scale, out_scale)


@_neck_op.register_fake
def _(f3_q, f4, f3_scale, out_scale):
    return f3_q.new_empty((*f3_q.shape[:3], f3_q.shape[3] + f4.shape[3]))


@_neck_op.register_kernel("cuda")
def _neck_cuda(f3_q, f4, f3_scale, out_scale):
    if f3_q.dtype != torch.int8 or f4.dtype != torch.float32:
        raise TypeError(f"int8_neck: want int8 f3_q and float32 f4, got "
                        f"{f3_q.dtype} and {f4.dtype}")
    if f3_q.dim() != 4 or f4.dim() != 4:
        raise ValueError(f"int8_neck: want f3_q (B, H, W, C3) and f4 (B, "
                         f"H/2, W/2, C4), got {tuple(f3_q.shape)} and "
                         f"{tuple(f4.shape)}")
    b, h, w, c3 = f3_q.shape
    c4 = f4.shape[3]
    if (h % 2 or w % 2 or tuple(f4.shape[:3]) != (b, h // 2, w // 2)
            or c3 % 8 or c4 % 8 or min(b, h, w, c3, c4) < 1):
        raise ValueError(f"int8_neck: want f3_q (B, H, W, C3) with H and W "
                         f"even, f4 (B, H/2, W/2, C4), C3 and C4 multiples "
                         f"of 8, got {tuple(f3_q.shape)} and "
                         f"{tuple(f4.shape)}")
    scales = (f3_scale, out_scale)
    if any(s.dtype != torch.float32 or s.numel() != 1 for s in scales):
        raise ValueError("int8_neck: want float32 scalar scales")
    if any(t.device != f3_q.device for t in (f4, *scales)):
        raise ValueError("int8_neck: tensors on different devices")
    if not (f3_q.is_contiguous() and f4.is_contiguous()):
        raise ValueError("int8_neck: f3_q and f4 must be contiguous")
    if f3_q.data_ptr() % ALIGNMENT or f4.data_ptr() % ALIGNMENT:
        raise ValueError(f"int8_neck: f3_q and f4 must be {ALIGNMENT}-byte "
                         f"aligned (a view that starts inside a tensor may "
                         f"not be: clone it)")
    h_taps = interp_taps(h // 2, h, f3_q.device)
    w_taps = interp_taps(w // 2, w, f3_q.device)
    out = torch.empty((b, h, w, c3 + c4), dtype=torch.int8,
                      device=f3_q.device)
    with torch.cuda.device(f3_q.device):
        rc = _launcher()(
            f3_q.data_ptr(), f4.data_ptr(), f3_scale.data_ptr(),
            out_scale.data_ptr(), h_taps.data_ptr(), w_taps.data_ptr(),
            out.data_ptr(), b, h, w, c3, c4,
            torch.cuda.current_stream(f3_q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_neck: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return out


def int8_neck(f3_q: torch.Tensor, f4: torch.Tensor, f3_scale: torch.Tensor,
              out_scale: torch.Tensor) -> torch.Tensor:
    """The heads' input codes of one pyramid scale, (B, H, W, C3 + C4)
    int8, through ``densebox::int8_neck``.

    CPU tensors take ``neck_reference``. CUDA tensors launch the kernel:
    ``f3_q`` int8 (B, H, W, C3), ``f4`` float32 (B, H/2, W/2, C4), both
    contiguous and 16-byte aligned, H and W even, C3 and C4 multiples of 8;
    ``f3_scale`` and ``out_scale`` float32 scalars on the same card.
    Anything else raises, and so does a refused launch. Each launch adds one
    to ``launches``."""
    if f3_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_neck: no kernel for device {f3_q.device}")
    return _neck_op(f3_q, f4, f3_scale, out_scale)
