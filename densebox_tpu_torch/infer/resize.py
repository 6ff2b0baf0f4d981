"""Linear image resize with jax.image.resize's semantics.

The JAX pyramid resizes with ``jax.image.resize(..., method="linear")``:
half-pixel centres, and a triangle filter widened by the scale factor when
downscaling (``antialias=True``, its default). ``F.interpolate`` does
neither in the same way, so this module builds the same per-axis weight
matrices (as ``jax/_src/image/scale.py:compute_weight_mat`` does, in
float32) and applies them as two matrix products, as jax does.
``weight_matrices`` does the same for ``jax.image.scale_and_translate``
with a scale and a translation per sample (the training patch crop), on the
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from densebox_tpu_torch.device import reference_precision
from densebox_tpu_torch.ops.decode import rdiv
from densebox_tpu_torch.utils.constants import constant_cache


def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 resampling weights of jax's linear resize along
    one axis (scale n_out / n_in, no translation, antialiased)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))     # triangle
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.ascontiguousarray(
        np.where(inside[None, :], weights, f32(0.0)).T.astype(f32))


def weight_matrices(n_in: int, n_out: int, scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) float32 resampling weights of
    ``jax.image.scale_and_translate(..., method="linear")`` along one axis,
    for (B,) float32 per-sample ``scale`` and ``translation`` on their
    device: output sample o reads input position
    (o + 0.5 - translation) / scale - 0.5 through a triangle filter, widened
    by 1 / scale when downscaling (antialias); weights are normalised per
    output sample and zero where the position falls outside the input.
    Operation by operation as ``compute_weight_mat`` of
    ``jax/_src/image/scale.py``."""
    dev = scale.device
    inv_scale = rdiv(1.0, scale)[:, None]                         # (B, 1)
    kernel_scale = inv_scale.clamp(min=1.0)
    out_pos = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    sample_f = out_pos * inv_scale - translation[:, None] * inv_scale - 0.5
    in_pos = torch.arange(n_in, dtype=torch.float32, device=dev)
    x = (sample_f[:, None, :] - in_pos[:, None]).abs() / kernel_scale[:, None]
    weights = (1.0 - x.abs()).clamp(min=0.0)                      # triangle
    total = weights.sum(dim=1, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


@constant_cache
def _weights(n_in: int, n_out: int, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    """``weight_matrix`` on the device, made once per shape (a blocking
    upload per call would stall the host until the card drains its queue).
    Read-only."""
    with torch.inference_mode(False):
        return torch.from_numpy(weight_matrix(n_in, n_out)).to(device, dtype)


def resize_linear(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, hs, ws, C) as ``jax.image.resize(images,
    (B, hs, ws, C), "linear")``, contiguous. An axis whose size does not
    change is left as it is, as jax does.

    ``einsum`` permutes the image into one GEMM over all images and
    channels. Batched products on NHWC as it lies (no permute) have only
    C = 3 columns, and on the H100 ran 7x slower than this."""
    _, h, w, _ = images.shape
    hs, ws = hw
    x = images
    with reference_precision(x.dtype):      # jax's resize: Precision.HIGHEST
        if hs != h:
            x = torch.einsum("oh,bhwc->bowc",
                             _weights(h, hs, x.device, x.dtype), x)
        if ws != w:
            x = torch.einsum("pw,bhwc->bhpc",
                             _weights(w, ws, x.device, x.dtype), x)
    return x.contiguous()
