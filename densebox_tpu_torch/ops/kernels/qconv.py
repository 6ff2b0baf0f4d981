"""Int8 conv with fused requant: the CUDA kernel's wrapper and its plain
version.

``qconv_int8`` replaces ``densebox_tpu/ops/pallas/qconv.py:qconv_int8``
(kernel ``_qconv_kernel``): a SAME, stride-1 conv (3x3 or 1x1) of NHWC int8
activations with int8 weights, an exact int32 accumulator, and one of three
outputs:

* ``out="auto"`` with ``out_scale`` given: int8 codes
  ``clip(round(y * out_scale), -127, 127)``;
* ``out="auto"`` with no ``out_scale``: ``y`` as float32;
* ``out="int32"``: the raw accumulator (``scale`` and ``bias`` unused),
  the conv of the hybrid chain, where JAX used XLA's int8 conv
  (``densebox_tpu/models/quant.py:_int8_conv``),

where ``y = relu?(f32(acc) * scale + bias)``, each operation rounded on its
own (see ``ops/kernels/requant.py``, whose plain epilogue this reuses).

Weights are laid out (Cout, k, k, Cin), Cin innermost, as the kernel reads
them; ``models/convert.py`` and ``models/quant.py`` produce that layout from
the JAX package's HWIO. The wrapper turns ``scale``, ``bias`` and
``out_scale`` into (Cout,) float32 tensors and calls the custom operator
``densebox::qconv_int8``: on a CUDA tensor it launches ``csrc/qconv.cu``
(built on first use) or raises; on a CPU tensor it runs ``qconv_reference``;
under ``torch.export`` it is one node whose fake rule gives the output's
shape and, by mode, its dtype.

The CUDA source holds two variants and one rule that picks between them,
``kernel_variant``: the int8 tensor cores (``mma``) whenever Cin is a
multiple of 16, the CUDA cores (``dp4a``) otherwise. The C side reports the
variant it took at every launch; the wrapper holds it against the rule and
counts launches per variant in ``variant_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from densebox_tpu_torch.ops.kernels import build
from densebox_tpu_torch.ops.kernels.requant import (MODE_F32, MODE_INT8,
                                                    MODE_INT32,
                                                    channel_vector,
                                                    requant_reference)

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0
# The same launches by variant name (``kernel_variant``).
variant_launches: Dict[str, int] = {}
# What the C side chose at the last launch: variant, and for the
# tensor-core variant the channels per chunk, whether the weights stayed in
# shared memory, the grid's x size, the dynamic shared memory in bytes and
# the depth of the ring of stages.
last_plan: Dict[str, object] = {}

MMA_CHANNEL_BLOCKS = (8, 16, 32, 64, 128)
DP4A_CHANNEL_BLOCKS = (16, 32, 64)
ALIGNMENT = 16      # bytes, of x, w and the output for the tensor-core variant


def reset_launches() -> None:
    global launches
    launches = 0
    variant_launches.clear()


def kernel_variant(cin: int, cout: int, k: int) -> str:
    """The variant of ``csrc/qconv.cu`` that a conv of these widths runs on,
    as ``"<path>_n<channel block>"``: ``mma`` (int8 tensor cores) whenever
    Cin is a multiple of 16, else ``dp4a`` (CUDA cores); the channel block
    is the smallest of the path's blocks that holds Cout (the largest above
    that). Mirrors ``channel_block`` in the source; the kernel size does not
    enter the rule."""
    if k not in (1, 3) or cin < 1 or cout < 1:
        raise ValueError(f"kernel_variant: want k in (1, 3) and positive "
                         f"widths, got cin={cin}, cout={cout}, k={k}")
    path, blocks = (("mma", MMA_CHANNEL_BLOCKS) if cin % 16 == 0
                    else ("dp4a", DP4A_CHANNEL_BLOCKS))
    block = next((n for n in blocks if cout <= n), blocks[-1])
    return f"{path}_n{block}"


def conv_accumulator(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator of a SAME conv: x (B, H, W, Cin) int8,
    w (Cout, k, k, Cin) int8 -> (B, H, W, Cout) int32, on x's device.

    One float64 matrix product per tap over the zero-padded input. Every
    product and partial sum is an integer below 9 * Cin * 128^2 < 2^53, so
    float64 holds it exactly in any summation order (float32 would not:
    the sums pass 2^24 at Cin >= 128)."""
    b, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    p = k // 2
    xp = F.pad(x.to(torch.float64), (0, 0, p, p, p, p))
    w64 = w.to(torch.float64)
    acc = torch.zeros((b * h * wd, cout), dtype=torch.float64, device=x.device)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, cin)
            acc.addmm_(tap, w64[:, dy, dx, :].t())
    return acc.to(torch.int32).reshape(b, h, wd, cout)


def qconv_reference(x: torch.Tensor, w: torch.Tensor, scale, bias,
                    out_scale=None, *, relu: bool = True,
                    out: str = "auto") -> torch.Tensor:
    """Plain version of ``qconv_int8``, on either device."""
    acc = conv_accumulator(x, w)
    if out == "int32":
        return acc
    return requant_reference(acc, scale, bias, out_scale, relu=relu)


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_qconv`` of csrc/qconv.cu, built and loaded on first use."""
    fn = build.load("qconv").densebox_qconv
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def _mode(out: str, out_scale) -> int:
    return (MODE_INT32 if out == "int32"
            else MODE_INT8 if out_scale is not None else MODE_F32)


_DTYPES = {MODE_INT32: torch.int32, MODE_F32: torch.float32,
           MODE_INT8: torch.int8}


@torch.library.custom_op(
    "densebox::qconv_int8", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, Tensor? scale, Tensor? bias, "
           "Tensor? out_scale, bool relu, str out) -> Tensor")
def _qconv_op(x, w, scale, bias, out_scale, relu, out):
    return qconv_reference(x, w, scale, bias, out_scale, relu=relu, out=out)


@_qconv_op.register_fake
def _(x, w, scale, bias, out_scale, relu, out):
    return x.new_empty((*x.shape[:3], w.shape[0]),
                       dtype=_DTYPES[_mode(out, out_scale)])


@_qconv_op.register_kernel("cuda")
def _qconv_cuda(x, w, scale, bias, out_scale, relu, out):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qconv_int8: want int8 x and w, got {x.dtype} and "
                        f"{w.dtype}")
    if (x.dim() != 4 or w.dim() != 4 or w.shape[1] != w.shape[2]
            or w.shape[1] not in (1, 3) or w.shape[3] != x.shape[3]):
        raise ValueError(f"qconv_int8: want x (B, H, W, Cin) and w (Cout, k, "
                         f"k, Cin) with k in (1, 3), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("qconv_int8: x and w on different devices")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("qconv_int8: x and w must be contiguous")
    b, h, wd, cin = x.shape
    cout, k = w.shape[0], w.shape[1]
    if not 1 <= b <= 65535 or min(h, wd) < 1:
        raise ValueError(f"qconv_int8: want 1 <= B <= 65535 and a nonempty "
                         f"image, got {tuple(x.shape)}")
    variant = kernel_variant(cin, cout, k)
    if variant.startswith("mma") and (x.data_ptr() % ALIGNMENT
                                      or w.data_ptr() % ALIGNMENT):
        raise ValueError(f"qconv_int8: with Cin a multiple of 16, x and w "
                         f"must be {ALIGNMENT}-byte aligned (a view that "
                         f"starts inside a tensor may not be: clone it)")
    mode = _mode(out, out_scale)
    vec = {}
    if mode != MODE_INT32:
        vec = {"scale": channel_vector(scale, cout, x.device),
               "bias": channel_vector(bias, cout, x.device)}
        if mode == MODE_INT8:
            vec["out_scale"] = channel_vector(out_scale, cout, x.device)
    y = torch.empty((b, h, wd, cout), dtype=_DTYPES[mode], device=x.device)

    def ptr(name):
        return vec[name].data_ptr() if name in vec else None

    info = (ctypes.c_int * 7)()
    with torch.cuda.device(x.device):
        rc = _launcher()(
            x.data_ptr(), w.data_ptr(), ptr("scale"), ptr("bias"),
            ptr("out_scale"), y.data_ptr(), b, h, wd, cin, cout, k,
            int(relu), mode,
            torch.cuda.current_stream(x.device).cuda_stream, info)
    if rc != 0:
        raise RuntimeError(f"qconv_int8: kernel launch failed with CUDA "
                           f"error {rc}")
    took = f"{'mma' if info[0] else 'dp4a'}_n{info[1]}"
    if took != variant:
        raise RuntimeError(f"qconv_int8: the kernel took variant {took}, "
                           f"kernel_variant names {variant}")
    global launches
    launches += 1
    variant_launches[variant] = variant_launches.get(variant, 0) + 1
    last_plan.clear()
    last_plan.update(variant=variant, chunk_channels=info[2],
                     weights_resident=bool(info[3]), grid_x=info[4],
                     shared_bytes=info[5], stages=info[6])
    return y


def qconv_int8(x: torch.Tensor, w: torch.Tensor, scale, bias,
               out_scale: Optional[torch.Tensor] = None, *, relu: bool = True,
               out: str = "auto") -> torch.Tensor:
    """SAME int8 conv + epilogue, (B, H, W, Cin) -> (B, H, W, Cout), through
    ``densebox::qconv_int8``.

    CPU tensors take ``qconv_reference``. CUDA tensors launch the kernel:
    ``x`` int8 (B, H, W, Cin) and ``w`` int8 (Cout, k, k, Cin), k in {1, 3},
    both contiguous on one card; ``scale``, ``bias`` and ``out_scale``
    float32 scalars or (Cout,) vectors. With Cin a multiple of 16 (the
    tensor-core variant) ``x`` and ``w`` must start on a 16-byte boundary.
    Anything else raises, and so does a refused launch or a variant other
    than ``kernel_variant`` names. Each launch adds one to ``launches`` and
    to its variant's entry of ``variant_launches``."""
    if out not in ("auto", "int32"):
        raise ValueError(f"qconv_int8: out must be 'auto' or 'int32', "
                         f"got {out!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qconv_int8: no kernel for device {x.device}")
    vec = [None, None, None]
    if out == "auto":
        cout = w.shape[0]
        vec = [None if v is None else channel_vector(v, cout, x.device)
               for v in (scale, bias, out_scale)]
    return _qconv_op(x, w, *vec, bool(relu), out)
