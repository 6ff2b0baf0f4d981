"""Int8 requant epilogue: the CUDA kernel's wrapper and its plain version.

``requant_epilogue`` replaces ``densebox_tpu/ops/pallas/requant.py:
requant_epilogue`` (kernel ``_kernel``): one elementwise pass over an int32
conv accumulator,

    y = relu?(f32(acc) * scale + bias)
    out = clip(round(y * out_scale), -127, 127) as int8, or y as f32
          when out_scale is None,

with ``scale``, ``bias`` and ``out_scale`` per output channel (the last
axis). Each operation rounds on its own in IEEE f32: there is no fused
multiply-add anywhere, so the kernel (``csrc/requant.cu``, built with
``-fmad=false``) and ``requant_reference`` agree bit for bit, and round
half to even as ``jnp.round`` does. On a CUDA tensor the wrapper launches
the kernel or raises; on a CPU tensor it runs ``requant_reference``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from densebox_tpu_torch.ops.kernels import build

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0

# Output modes of the C interface (csrc/epilogue.cuh).
MODE_INT32, MODE_F32, MODE_INT8 = 0, 1, 2


def reset_launches() -> None:
    global launches
    launches = 0


def channel_vector(v, cout: int, device) -> torch.Tensor:
    """A scalar or (Cout,) value as a contiguous (Cout,) float32 tensor."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v.expand(cout).contiguous()


def requant_reference(acc: torch.Tensor, scale, bias,
                      out_scale=None, *, relu: bool = True) -> torch.Tensor:
    """Plain version: (..., Cout) int32 -> int8 (``out_scale`` given) or
    float32, one separately rounded f32 operation at a time."""
    cout = acc.shape[-1]
    y = acc.to(torch.float32) * channel_vector(scale, cout, acc.device)
    y = y + channel_vector(bias, cout, acc.device)
    if relu:
        y = y.clamp_min(0.0)
    if out_scale is None:
        return y
    q = torch.round(y * channel_vector(out_scale, cout, acc.device))
    return q.clamp(-127.0, 127.0).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_requant`` of csrc/requant.cu, built and loaded on first use."""
    fn = build.load("requant").densebox_requant
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def requant_epilogue(acc: torch.Tensor, scale, bias,
                     out_scale: Optional[torch.Tensor] = None, *,
                     relu: bool = True) -> torch.Tensor:
    """Dequant + bias + ReLU + requant of an int32 accumulator (B, H, W, Cout).

    CPU tensors take ``requant_reference``. CUDA tensors launch the kernel:
    ``acc`` int32 and contiguous; ``scale``, ``bias`` and ``out_scale``
    float32 scalars or (Cout,) vectors on the same device. Anything else
    raises, and so does a refused launch. Returns int8 when ``out_scale`` is
    given, else float32, in ``acc``'s shape."""
    if acc.device.type == "cpu":
        return requant_reference(acc, scale, bias, out_scale, relu=relu)
    if acc.device.type != "cuda":
        raise ValueError(f"requant_epilogue: no kernel for device {acc.device}")
    if acc.dtype != torch.int32 or not acc.is_contiguous() or acc.dim() < 1:
        raise ValueError(f"requant_epilogue: want a contiguous int32 "
                         f"accumulator, got {acc.dtype} {tuple(acc.shape)}")
    cout = acc.shape[-1]
    if not 1 <= cout <= 4096:
        raise ValueError(f"requant_epilogue: want 1 <= Cout <= 4096, "
                         f"got {cout}")
    vec = {"scale": scale, "bias": bias, "out_scale": out_scale}
    vec = {k: (v if v is None else channel_vector(v, cout, acc.device))
           for k, v in vec.items()}
    quant = out_scale is not None
    out = torch.empty(acc.shape, device=acc.device,
                      dtype=torch.int8 if quant else torch.float32)
    with torch.cuda.device(acc.device):
        rc = _launcher()(
            acc.data_ptr(), vec["scale"].data_ptr(), vec["bias"].data_ptr(),
            vec["out_scale"].data_ptr() if quant else None, out.data_ptr(),
            acc.numel(), cout, int(relu), MODE_INT8 if quant else MODE_F32,
            torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"requant_epilogue: kernel launch failed with "
                           f"CUDA error {rc}")
    global launches
    launches += 1
    return out
