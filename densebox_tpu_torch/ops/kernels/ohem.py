"""OHEM hard-negative selection: the CUDA kernel's wrapper and its plain
version.

``ohem_select`` replaces ``densebox_tpu/ops/pallas/ohem.py:ohem_mask_pallas``
(kernel ``_ohem_kernel`` with ``_count_threshold``). Per sample over P
pixels it keeps every positive and samples ``n_neg = round(ratio * n_pos)``
negatives (``min_neg`` for a sample without positives, never more than there
are candidates, never from the gray zone): ``floor(hard_frac * n_neg)`` of
them the candidates with the largest squared error, found by a 40-step
float32 threshold bisection, ties at the cutoff filled in the order of the
uniform noise, and the rest the remaining candidates with the largest noise.
The noise is an input, (B, P) uniforms in [0, 1), as in the TPU kernel: the
caller draws it (tests hand both packages the same draw).

Counts are integers, so the kernel, the plain version and the TPU kernel in
interpret mode give the same mask bit for bit. Squared errors and noise are
expected finite and >= 0. On a CUDA tensor the wrapper launches
``csrc/ohem.cu`` (built on first use) or raises; on a CPU tensor it runs
``ohem_select_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from densebox_tpu_torch.ops.kernels import build

# Kernel launches since the last reset; only the launch site adds to it.
launches = 0

BISECT_ITERS = 40
MAX_P = 16384        # 512 threads x 32 values in registers (csrc/ohem.cu)


def reset_launches() -> None:
    global launches
    launches = 0


def _count_threshold(values: torch.Tensor, cand: torch.Tensor,
                     n_want: torch.Tensor) -> torch.Tensor:
    """Per row, bisect t so that count(cand & values > t) <= n_want, as the
    TPU kernel does: lo = -1, hi = max + 1, 40 halvings. (B, P) values and
    cand, (B,) n_want -> (B,) float32."""
    hi = torch.where(cand, values, 0.0).amax(dim=1) + 1.0
    lo = torch.full_like(hi, -1.0)
    for _ in range(BISECT_ITERS):
        mid = (lo + hi) * 0.5
        cnt = (cand & (values > mid[:, None])).sum(dim=1)
        too_many = cnt > n_want
        lo = torch.where(too_many, mid, lo)
        hi = torch.where(too_many, hi, mid)
    return hi


def ohem_select_reference(sq: torch.Tensor, pos: torch.Tensor,
                          ign: torch.Tensor, rnd: torch.Tensor, ratio: float,
                          hard_frac: float, min_neg: int) -> torch.Tensor:
    """Plain version of ``ohem_select``: the same bisections with torch
    operations over (B, P). Returns the (B, P) bool mask."""
    neg_cand = ~pos & ~ign
    npos = pos.sum(dim=1)
    n_neg = torch.where(npos > 0,
                        torch.round(npos.float() * ratio).long(),
                        torch.full_like(npos, min_neg))
    n_neg = torch.minimum(n_neg, neg_cand.sum(dim=1))
    n_hard = torch.floor(n_neg.float() * hard_frac).long()
    n_rand = n_neg - n_hard

    t_hard = _count_threshold(sq, neg_cand, n_hard)
    above = neg_cand & (sq > t_hard[:, None])
    n_above = above.sum(dim=1)
    vstar = torch.where(neg_cand & ~above, sq, float("-inf")).amax(dim=1)
    ties = neg_cand & (sq == vstar[:, None])
    t_tie = _count_threshold(rnd, ties, n_hard - n_above)
    hard_sel = above | (ties & (rnd > t_tie[:, None]))

    rand_cand = neg_cand & ~hard_sel
    t_rand = _count_threshold(rnd, rand_cand, n_rand)
    rand_sel = rand_cand & (rnd > t_rand[:, None])
    return pos | hard_sel | rand_sel


@functools.lru_cache(maxsize=None)
def _launcher():
    """``densebox_ohem_select`` of csrc/ohem.cu, built and loaded on first
    use."""
    fn = build.load("ohem").densebox_ohem_select
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ohem_select(sq: torch.Tensor, pos: torch.Tensor, ign: torch.Tensor,
                rnd: torch.Tensor, ratio: float, hard_frac: float,
                min_neg: int) -> torch.Tensor:
    """(B, P) float32 squared errors and uniforms, (B, P) bool positives and
    gray zone -> (B, P) bool sampling mask. ``ratio`` and ``hard_frac`` are
    rounded to float32 once.

    CPU tensors take ``ohem_select_reference``. CUDA tensors (contiguous, on
    one device, 1 <= P <= 16384) launch the kernel; anything else raises,
    and so does a refused launch. Each launch adds one to ``launches``."""
    ratio = float(np.float32(ratio))
    hard_frac = float(np.float32(hard_frac))
    min_neg = int(min_neg)
    if min_neg < 0:
        raise ValueError(f"ohem_select: want min_neg >= 0, got {min_neg}")
    if sq.device.type == "cpu":
        return ohem_select_reference(sq, pos, ign, rnd, ratio, hard_frac,
                                     min_neg)
    if sq.device.type != "cuda":
        raise ValueError(f"ohem_select: no kernel for device {sq.device}")
    if sq.dtype != torch.float32 or rnd.dtype != torch.float32:
        raise TypeError(f"ohem_select: want float32 errors and uniforms, got "
                        f"{sq.dtype} and {rnd.dtype}")
    if pos.dtype != torch.bool or ign.dtype != torch.bool:
        raise TypeError(f"ohem_select: want bool pos and ign, got "
                        f"{pos.dtype} and {ign.dtype}")
    if sq.dim() != 2 or any(t.shape != sq.shape for t in (pos, ign, rnd)):
        raise ValueError(f"ohem_select: want four (B, P) tensors, got "
                         f"{[tuple(t.shape) for t in (sq, pos, ign, rnd)]}")
    b, p = sq.shape
    if not (b >= 1 and 1 <= p <= MAX_P):
        raise ValueError(f"ohem_select: want B >= 1 and 1 <= P <= {MAX_P}, "
                         f"got B={b} P={p}")
    if any(t.device != sq.device for t in (pos, ign, rnd)):
        raise ValueError("ohem_select: tensors on different devices")
    if not all(t.is_contiguous() for t in (sq, pos, ign, rnd)):
        raise ValueError("ohem_select: tensors must be contiguous")
    mask = torch.empty((b, p), dtype=torch.bool, device=sq.device)
    with torch.cuda.device(sq.device):
        rc = _launcher()(
            sq.data_ptr(), rnd.data_ptr(), pos.data_ptr(), ign.data_ptr(),
            mask.data_ptr(), b, p, ratio, hard_frac, min_neg,
            torch.cuda.current_stream(sq.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ohem_select: kernel launch failed with CUDA "
                           f"error {rc}")
    global launches
    launches += 1
    return mask
