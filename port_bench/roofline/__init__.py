"""Operations, bytes and least times of the work a cell runs, from shapes
alone, against the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at its 700 W power limit): what a roofline share or an
``mfu`` divides by.

An operation is one multiply or one add (a multiply-add is two). A
kernel's bytes count each input read once and each output written once.
The int8 convolution's bytes follow ``qconv_int8``'s interface: int8
activations in, its int8 weights, three float32 vectors per output
channel, and the output in the mode the chain runs it in (int8 codes, or
float32 where no conv reads it next).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from port_bench.reference.model import (conv_specs, pyramid_shapes,
                                        resize_weights, trunk)

# operations per second by the dtype a product runs in; f32 is the CUDA
# cores' rate (TF32 off), which the float32 configurations run at
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class Launch(NamedTuple):
    name: str
    b: int
    h: int
    w: int
    cin: int
    cout: int
    k: int
    out_bytes: int


def conv_ops(b: int, h: int, w: int, cin: int, cout: int, k: int) -> float:
    """Operations of a stride-1 SAME conv: two per multiply-add."""
    return 2.0 * b * h * w * cin * cout * k * k


def qconv_bytes(l: Launch) -> float:
    return (l.b * l.h * l.w * (l.cin + l.cout * l.out_bytes)
            + l.cout * l.k * l.k * l.cin + 12 * l.cout)


def bound_s(ops: float, nbytes: float, dtype: str):
    """(least seconds, "operations" | "bytes"): the larger of the two."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def qconv_bound_s(l: Launch) -> float:
    return bound_s(conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k),
                   qconv_bytes(l), "int8")[0]


def level_convs(model: dict, b: int, hs: int, ws: int) -> List[Launch]:
    """Every conv of one pyramid level of ``b`` images of hs x ws, with the
    bytes per output element of the int8 chain: int8 where the next conv
    reads the codes, float32 at the end of the trunk, of each head and of
    the refine branch."""
    names = [n for kd, n, _ in trunk(model) if kd == "conv"]
    f32_out = {names[-1], "refine_out"} | {
        c.name for c in conv_specs(model) if c.name.endswith("_conv2")}
    return [Launch(c.name, b, hs // c.stride, ws // c.stride, c.cin, c.cout,
                   c.k, 4 if c.name in f32_out else 1)
            for c in conv_specs(model)]


def detect_launches(model: dict, b: int, hw, scales) -> List[Launch]:
    """The convs of one detect call over the pyramid."""
    out = []
    for hs, ws, _, _ in pyramid_shapes(hw[0], hw[1], scales):
        out += level_convs(model, b, hs, ws)
    return out


def _nnz(n_in: int, n_out: int) -> int:
    return int(np.count_nonzero(resize_weights(n_in, n_out)))


def detect_products(model: dict, b: int, hw, scales, conv_dtype: str
                    ) -> Dict[str, float]:
    """Operations of one detect call by the dtype they run in: the convs
    and head products in ``conv_dtype`` ("int8" or "bf16"), and in float32
    the pyramid's resize (its nonzero weights only) and the x2 upsample
    (two weights an output, each axis)."""
    h, w = hw
    ops = {conv_dtype: 0.0, "f32": 0.0}
    c4 = [c for c in conv_specs(model) if c.name.startswith("conv4")][-1].cout
    for hs, ws, _, _ in pyramid_shapes(h, w, scales):
        for l in level_convs(model, b, hs, ws):
            ops[conv_dtype] += conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k)
        if (hs, ws) != (h, w):
            if hs != h:
                ops["f32"] += 2.0 * b * _nnz(h, hs) * w * 3
            if ws != w:
                ops["f32"] += 2.0 * b * _nnz(w, ws) * hs * 3
        h8, w8 = hs // 8, ws // 8
        ops["f32"] += 2.0 * 2 * b * h8 * (2 * w8) * c4      # along W
        ops["f32"] += 2.0 * 2 * b * (2 * h8) * (2 * w8) * c4  # along H
    return ops


def least_s(ops: Dict[str, float]) -> float:
    """Seconds of ``ops`` (dtype -> operations) at the peak of each dtype."""
    return sum(v / PEAK_OPS_PER_S[k] for k, v in ops.items())


def train_products(model: dict, b: int, patch: int) -> Dict[str, float]:
    """Operations of one float32 train step on ``b`` patches: every conv
    forward, its weight gradient, and its input gradient except the first
    conv's (the image needs none); the x2 upsample forward and its input
    gradient. The patch crop is left out (its weights depend on the
    draws; under 0.3% of the step)."""
    convs = level_convs(model, b, patch, patch)
    fwd = [conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k) for l in convs]
    c4 = [c for c in conv_specs(model) if c.name.startswith("conv4")][-1].cout
    h8 = patch // 8
    up = 2.0 * 2 * b * h8 * (2 * h8) * c4 + 2.0 * 2 * b * (2 * h8) ** 2 * c4
    return {"f32": 3 * sum(fwd) - fwd[0] + 2 * up}
