"""Plain DenseBox forwards: float (float32, TF32 off), the int8 chain with
exact integer convolutions, and the bf16 walk that calibrates it.

Written from the paper's architecture (arXiv:1509.04874 §3.2, §4) and the
configuration file's ``model`` group: a VGG-19 trunk through conv4_4 (three
2x2 max-pools), f3 (the last conv3) concatenated with f4 upsampled x2
(bilinear, align corners), 1x1 det / loc / lm heads (conv1 + ReLU + conv2)
and the refine branch over score ++ landmarks. Tensors are NHWC at the
edges, as the configuration's maps are.

The int8 chain is the one the configuration states: symmetric
per-output-channel weights (``max|w| / 127``), one absmax input scale per
conv measured over the calibration images by a bfloat16 walk, int32
accumulators, a float32 epilogue (``f32(acc) * (in_scale * w_scale) +
bias``, ReLU, requantised by the next conv's ``1 / in_scale``) and
bfloat16 between the trunk and the heads. ``qmax`` 127 is that chain;
``qmax`` 7 is the same chain in int4, the control.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


class Conv(NamedTuple):
    name: str
    cin: int
    cout: int
    k: int
    stride: int        # of its input, against the level's image


def scaled(c: int, width_mult: float) -> int:
    """A conv width at ``width_mult``, rounded to a multiple of 8."""
    return max(8, int(round(c * width_mult / 8)) * 8)


def trunk(model: dict) -> List[Tuple[str, str, int]]:
    """(kind, name, base width) of the paper trunk with ``trunk_depth``
    convs in each of conv3 and conv4."""
    if model.get("stem", "conv") != "conv":
        raise ValueError("the reference runs the paper's conv stem only")
    d = model["trunk_depth"]
    plan = [("conv", "conv1_1", 64), ("conv", "conv1_2", 64),
            ("pool", "pool1", 0), ("conv", "conv2_1", 128),
            ("conv", "conv2_2", 128), ("pool", "pool2", 0)]
    plan += [("conv", f"conv3_{i + 1}", 256) for i in range(d)]
    plan += [("pool", "pool3", 0)]
    plan += [("conv", f"conv4_{i + 1}", 512) for i in range(d)]
    return plan


def heads(model: dict) -> List[Tuple[str, int]]:
    out = [("det", 1), ("loc", 4)]
    if model["num_landmarks"]:
        out.append(("lm", model["num_landmarks"]))
    return out


def conv_specs(model: dict) -> List[Conv]:
    """Every conv, in the order of the model's parameter list: trunk, the
    heads (conv1, conv2), the refine branch."""
    wm = model["width_mult"]
    convs, cin, stride, c3 = [], 3, 1, None
    for kind, name, width in trunk(model):
        if kind == "pool":
            stride *= 2
            continue
        cout = scaled(width, wm)
        convs.append(Conv(name, cin, cout, 3, stride))
        cin = cout
        if name.startswith("conv3"):
            c3 = cout
    feat, hw = c3 + cin, scaled(model["head_width"], wm)
    for pfx, oc in heads(model):
        convs.append(Conv(f"{pfx}.{pfx}_conv1", feat, hw, 1, 4))
        convs.append(Conv(f"{pfx}.{pfx}_conv2", hw, oc, 1, 4))
    if model["num_landmarks"] and model["use_refine"]:
        rw = model["refine_width"]
        convs.append(Conv("refine_conv1", 1 + model["num_landmarks"], rw, 3, 4))
        convs.append(Conv("refine_conv2", rw, rw, 3, 4))
        convs.append(Conv("refine_out", rw, 1, 1, 4))
    return convs


@contextlib.contextmanager
def full_f32(tf32: bool = False):
    """float32 products in float32: TF32 off in cuDNN and cuBLAS (on with
    ``tf32``, the control of a float32 cell)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --- the pyramid's resize ---------------------------------------------------

def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of a linear resize with half-pixel
    centres and a triangle widened by the scale when downscaling
    (antialiased), normalised per output sample, as ``jax.image.resize``
    computes them."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    ks = max(inv, f32(1.0))
    pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(pos[None, :] - np.arange(n_in, dtype=f32)[:, None]) / ks
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T
                                .astype(f32))


def resize(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, hs, ws, C): rows, then columns."""
    _, h, w, _ = images.shape
    x = images
    dev = x.device
    with full_f32():
        if hw[0] != h:
            wh = torch.from_numpy(resize_weights(h, hw[0])).to(dev)
            x = torch.einsum("oh,bhwc->bowc", wh, x)
        if hw[1] != w:
            ww = torch.from_numpy(resize_weights(w, hw[1])).to(dev)
            x = torch.einsum("pw,bhwc->bhpc", ww, x)
    return x.contiguous()


def pyramid_shapes(h: int, w: int, scales, multiple: int = 8):
    """Per scale: (hs, ws, sx, sy), each side rounded up to ``multiple``,
    with the actual factors ws / w and hs / h."""
    def up(v):
        return max(multiple, -(-int(round(v)) // multiple) * multiple)
    return [(up(h * s), up(w * s), up(w * s) / w, up(h * s) / h)
            for s in scales]


# --- float forward ----------------------------------------------------------

def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    pos = np.arange(n_out, dtype=np.float64) * (n_in - 1) / max(n_out - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 2)
    m = np.zeros((n_out, n_in), np.float64)
    m[np.arange(n_out), lo] = 1.0 - (pos - lo)
    m[np.arange(n_out), lo + 1] = pos - lo
    return m.astype(np.float32)


def upsample2x(x: torch.Tensor, round_to: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """x2 bilinear upsample with aligned corners of an NHWC tensor: along
    W, then along H, each a float32 product with the interpolation matrix
    (broadcast over the batch). With ``round_to`` the matrix's weights are
    in that dtype and each product is rounded to it after, as a model
    computing in that dtype has them."""
    b, h, w, c = x.shape
    dt = round_to or torch.float32
    aw = torch.from_numpy(_align_corners_matrix(w, 2 * w)).to(x.device, dt)
    ah = torch.from_numpy(_align_corners_matrix(h, 2 * h)).to(x.device, dt)

    def along(a, t):
        y = torch.bmm(a.float().expand(t.shape[0], *a.shape), t.float())
        return y.to(round_to) if round_to is not None else y

    with full_f32():
        y = along(aw, x.reshape(b * h, w, c))
        y = along(ah, y.reshape(b, h, 2 * w * c))
    return y.reshape(b, 2 * h, 2 * w, c)


FP8_MAX = 448.0     # the largest float8 e4m3 value


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """``x`` through float8 e4m3, scaled per slice over ``dims`` so that
    its absmax lands on the format's largest value."""
    s = (x.abs().amax(dim=dims, keepdim=True) / FP8_MAX).clamp_min(1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def forward_float(weights: Dict[str, torch.Tensor], model: dict,
                  images: torch.Tensor, fp8: bool = False,
                  dropout: Optional[Tuple[torch.Tensor, float]] = None,
                  tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The float forward in float32 (TF32 off) of (B, H, W, 3) images ->
    NHWC float32 maps ``score``, ``loc`` [, ``lm``, ``refined``]. With
    ``fp8`` every conv takes its input (scaled per image) and weights
    (per output channel) through float8 e4m3: the control of a bfloat16
    cell. ``dropout`` (keep, keep probability)
    drops the heads' hidden units where the bool (B, h, w, heads * width)
    ``keep`` is false and scales the rest by 1 / keep probability.
    ``tf32`` lets the products run in TF32."""
    w = {k: v.float() for k, v in weights.items()}

    def conv(x, name, relu=True):
        k, b = w[f"{name}.weight"], w[f"{name}.bias"]
        if fp8:
            x, k = _fp8(x, (1, 2, 3)), _fp8(k, (1, 2, 3))
        y = F.conv2d(x, k, b, padding=k.shape[-1] // 2)
        return torch.relu(y) if relu else y

    with full_f32(tf32):
        x, f3 = images.float().permute(0, 3, 1, 2), None
        last3 = [n for kd, n, _ in trunk(model) if n.startswith("conv3")][-1]
        for kind, name, _ in trunk(model):
            if kind == "pool":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = conv(x, name)
                if name == last3:
                    f3 = x
        up = upsample2x(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        feat = torch.cat([f3, up], dim=1)
        out = {}
        for i, (pfx, _) in enumerate(heads(model)):
            h = conv(feat, f"{pfx}.{pfx}_conv1")
            if dropout is not None:
                keep, kp = dropout
                width = h.shape[1]
                k = keep[..., i * width:(i + 1) * width].permute(0, 3, 1, 2)
                h = torch.where(k, h / torch.full((), kp, device=h.device), 0.0)
            out[pfx] = conv(h, f"{pfx}.{pfx}_conv2", relu=False)
        maps = {"score": out["det"], "loc": out["loc"]}
        if model["num_landmarks"]:
            maps["lm"] = out["lm"]
            if model["use_refine"]:
                r = torch.cat([out["det"], out["lm"]], dim=1)
                r = conv(conv(r, "refine_conv1"), "refine_conv2")
                maps["refined"] = conv(r, "refine_out", relu=False)
    return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in maps.items()}


# --- the int8 chain ---------------------------------------------------------

def quant_codes(x: torch.Tensor, scale: torch.Tensor, qmax: int
                ) -> torch.Tensor:
    """round(x / scale) clipped to [-qmax, qmax], as float32 codes."""
    return torch.round(x.float() / scale).clamp(-qmax, qmax)


def calibrate(weights: Dict[str, torch.Tensor], model: dict,
              images: torch.Tensor, qmax: int = 127
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Quantise every conv: per output channel ``w_scale = max|w| / qmax``
    and codes ``round(w / w_scale)``; ``in_scale = absmax / qmax`` of the
    conv's input over ``images`` in the bfloat16 walk (each conv of bfloat16
    values summed in float32 and rounded to bfloat16, then a bfloat16 bias
    add, ReLU; every head on its own). Returns name -> {w_q (Cout, k, k,
    Cin) float32 codes, w_scale (Cout,), in_scale (), bias (Cout,)}."""
    dev = images.device
    taps: Dict[str, torch.Tensor] = {}

    def conv(x, name, relu=True):
        taps[name] = x.abs().amax().float()
        k = weights[f"{name}.weight"].to(dev, BF16).float()
        with full_f32():
            y = F.conv2d(x.float().permute(0, 3, 1, 2), k,
                         padding=k.shape[-1] // 2).permute(0, 2, 3, 1)
        y = y.to(BF16) + weights[f"{name}.bias"].to(dev, BF16)
        return torch.relu(y) if relu else y

    last3 = [n for _, n, _ in trunk(model) if n.startswith("conv3")][-1]
    x, f3 = images.to(BF16), None
    with torch.no_grad():
        for kind, name, _ in trunk(model):
            if kind == "pool":
                x = _pool(x)
            else:
                x = conv(x, name)
                if name == last3:
                    f3 = x
        feat = torch.cat([f3, upsample2x(x, BF16)], dim=-1)
        outs = {}
        for pfx, _ in heads(model):
            outs[pfx] = conv(conv(feat, f"{pfx}.{pfx}_conv1"),
                             f"{pfx}.{pfx}_conv2", relu=False)
        if model["num_landmarks"] and model["use_refine"]:
            r = torch.cat([outs["det"], outs["lm"]], dim=-1)
            conv(conv(conv(r, "refine_conv1"), "refine_conv2"), "refine_out",
                 relu=False)
    q = {}
    for c in conv_specs(model):
        wf = weights[f"{c.name}.weight"].to(dev, torch.float32)
        s = (wf.abs().amax(dim=(1, 2, 3)) / float(qmax)).clamp_min(1e-12)
        codes = torch.round(wf / s[:, None, None, None]).clamp(-qmax, qmax)
        q[c.name] = {"w_q": codes.permute(0, 2, 3, 1).contiguous(),
                     "w_scale": s,
                     "in_scale": (taps[c.name] / float(qmax)).clamp_min(1e-12),
                     "bias": weights[f"{c.name}.bias"].to(dev, torch.float32)}
    return q


def _pool(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def int_conv(codes: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact accumulator of a SAME conv of integer codes (B, H, W, Cin)
    with weight codes (Cout, k, k, Cin): one float64 product per tap, every
    partial sum an integer below 2**53. Returns float64 (B, H, W, Cout)."""
    b, h, w, cin = codes.shape
    cout, k = w_q.shape[0], w_q.shape[1]
    p = k // 2
    xp = F.pad(codes.double(), (0, 0, p, p, p, p))
    wd = w_q.double()
    acc = torch.zeros((b * h * w, cout), dtype=torch.float64,
                      device=codes.device)
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
            acc.addmm_(tap, wd[:, dy, dx, :].t())
    return acc.reshape(b, h, w, cout)


def forward_int8(q: Dict[str, Dict[str, torch.Tensor]], model: dict,
                 images: torch.Tensor, qmax: int = 127
                 ) -> Dict[str, torch.Tensor]:
    """The int8 chain of (B, H, W, 3) float32 images with the quantised
    convs ``q`` (``calibrate``) -> NHWC float32 maps."""
    names = [n for kd, n, _ in trunk(model) if kd == "conv"]
    nxt = dict(zip(names[:-1], names[1:]))
    last3 = [n for n in names if n.startswith("conv3")][-1]

    def conv(codes, name, to, relu=True):
        c = q[name]
        acc = int_conv(codes, c["w_q"])
        y = acc.float() * (c["in_scale"] * c["w_scale"])
        y = y + c["bias"]
        if relu:
            y = y.clamp_min(0.0)
        if to is None:
            return y
        return torch.round(y * (1.0 / q[to]["in_scale"])).clamp(-qmax, qmax)

    with torch.no_grad():
        x = quant_codes(images, q[names[0]]["in_scale"], qmax)
        f3 = None
        for kind, name, _ in trunk(model):
            if kind == "pool":
                x = _pool(x)
            else:
                x = conv(x, name, nxt.get(name))
                if name == last3:
                    f3 = x
        f4 = x.to(BF16)
        f3 = (f3 * q[nxt[last3]]["in_scale"]).to(BF16)
        feat = torch.cat([f3, upsample2x(f4, BF16)], dim=-1)
        out = {}
        for pfx, _ in heads(model):
            c1, c2 = f"{pfx}.{pfx}_conv1", f"{pfx}.{pfx}_conv2"
            h = conv(quant_codes(feat, q[c1]["in_scale"], qmax), c1, c2)
            out[pfx] = conv(h, c2, None, relu=False)
        maps = {"score": out["det"], "loc": out["loc"]}
        if model["num_landmarks"]:
            maps["lm"] = out["lm"]
            if model["use_refine"]:
                r = torch.cat([out["det"].to(BF16), out["lm"].to(BF16)], -1)
                r = quant_codes(r, q["refine_conv1"]["in_scale"], qmax)
                r = conv(r, "refine_conv1", "refine_conv2")
                r = conv(r, "refine_conv2", "refine_out")
                maps["refined"] = conv(r, "refine_out", None, relu=False)
    return maps


def pyramid(forward, images: torch.Tensor, scales,
            rows: Optional[torch.Tensor] = None) -> List[Tuple[dict, tuple]]:
    """``forward`` of (B, H, W, 3) images at every scale, each with its
    (sx, sy). With ``rows`` the whole batch is resized (the resize's
    float32 sums then run in the order they run in over that batch) and
    only those rows go on through ``forward``."""
    _, h, w, _ = images.shape
    out = []
    for hs, ws, sx, sy in pyramid_shapes(h, w, scales):
        x = images if (hs, ws) == (h, w) else resize(images, (hs, ws))
        if rows is not None:
            x = x.index_select(0, rows)
        out.append((forward(x), (sx, sy)))
    return out
