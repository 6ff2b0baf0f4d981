"""The x2 bilinear upsample with align-corners semantics, as the JAX
model's ``upsample2x_align_corners``: the 1-D interpolation matrices, their
device copies made once per shape, and the two batched products.

Both the float ``DenseBox`` and the int8 chain (its calibration and the
plain version of ``ops/kernels/neck.py``) upsample f4 through these.
"""

from __future__ import annotations

import numpy as np
import torch

from densebox_tpu_torch.device import reference_precision
from densebox_tpu_torch.utils.constants import constant_cache


def interp_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) 1-D bilinear interpolation matrix with
    align_corners=True semantics: output sample o reads input position
    o * (n_in - 1) / (n_out - 1)."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    w = pos - lo
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), lo] = 1.0 - w
    m[np.arange(n_out), lo + 1] = w
    return m.astype(np.float32)


@constant_cache
def _interp_matrix(n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``interp_matrix_align_corners`` on the device, made once per shape:
    a blocking upload in every forward would stall the host until the
    card drains its queue. A normal tensor even when first made under
    inference mode, so that autograd may save it. Read-only."""
    with torch.inference_mode(False):
        return torch.from_numpy(interp_matrix_align_corners(n_in, n_out)).to(
            device, dtype)


def interp_bmm(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a`` (m, k), broadcast over the batch with stride 0, times each
    (k, n) matrix of ``x`` (B, k, n), in x's dtype. A bfloat16 product is
    taken in float32 (TF32 off) and rounded to bfloat16 once, as the CPU's
    bfloat16 product and the reference's bfloat16 dot (float32
    accumulation) round: cuBLAS's bfloat16 GEMM gives another last bit in
    rare elements, with or without its reduced-precision reduction
    (measured on the H100), while each output's float32 sum of its two
    exact products is the same in any order."""
    if x.dtype != torch.bfloat16:
        return torch.bmm(a.expand(x.shape[0], *a.shape), x)
    with reference_precision(torch.float32):
        y = torch.bmm(a.float().expand(x.shape[0], *a.shape), x.float())
    return y.to(x.dtype)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample (align_corners) of an NHWC tensor as two
    products with the interpolation matrices (in x's dtype), W first as in
    the JAX model, each rounded to x's dtype (``interp_bmm``). Returns a
    contiguous NHWC tensor. Batched products against the matrix broadcast
    with stride 0, so that the activation is neither copied nor transposed
    (``torch.matmul`` and ``einsum`` would transpose it)."""
    b, h, w, c = x.shape
    aw = _interp_matrix(w, 2 * w, x.device, x.dtype)
    ah = _interp_matrix(h, 2 * h, x.device, x.dtype)
    y = interp_bmm(aw, x.reshape(b * h, w, c))
    y = interp_bmm(ah, y.reshape(b, h, 2 * w * c))
    return y.reshape(b, 2 * h, 2 * w, c)
