"""Int8 post-training-quantised DenseBox (port of ``densebox_tpu/models/quant.py``).

Symmetric per-output-channel int8 weights, one absmax-calibrated input
scale per conv, int8 convs with int32 accumulation, and an f32 epilogue
that dequantises, adds the bias, applies ReLU and requantises by the NEXT
conv's input scale, so activations stay int8 between convs. This is the
JAX package's ``_forward_fused`` chain (its backends ``'pallas'`` and
``'hybrid'``), the one whose TPU kernels this port replaces: on the card
every conv is ``ops/kernels/qconv.py`` (and, for ``backend='hybrid'``,
``ops/kernels/requant.py``); on the CPU their plain versions. Backend
``'xla'`` is the JAX package's default chain (``_forward`` with qparams at
its ``'auto'`` settings), with bf16 tensors between the convs.

Usage (the detector and the server take it like the float model):

    sd = quantize_densebox(float_state_dict, cfg, calib_images)
    model = QuantDenseBox(cfg, device="cuda")
    model.load_state_dict(sd)
    detect = make_detect_fn(model, infer_cfg, label_cfg)

``models/convert.py:qparams_from_jax`` loads the JAX package's qparams
instead. Not ported: the knobs ``acc_dtype``, ``up_int8``, ``head_fuse``
and ``tail`` of JAX's ``'xla'`` chain, TPU A/Bs (ROADMAP.md); ``'xla'``
runs at their ``'auto'`` values (int32 accumulators, bf16 upsample, one
conv per head, int8 tail convs).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from densebox_tpu_torch.config import ModelCfg
from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.models.densebox import (DenseBox, check_divisible,
                                                space_to_depth, trunk_plan,
                                                upsample2x_align_corners)
from densebox_tpu_torch.ops.kernels.qconv import qconv_int8
from densebox_tpu_torch.ops.kernels.requant import (channel_vector,
                                                    requant_epilogue)
from densebox_tpu_torch.utils.constants import is_plain

GLUE = torch.bfloat16   # dtype of the float tensors between int8 stages
BACKENDS = ("fused", "hybrid", "xla")


def conv_shapes(cfg: ModelCfg) -> Dict[str, Tuple[int, int, int, int]]:
    """Every conv of the model as name -> float weight shape (Cout, Cin, k,
    k), in the order of the JAX package's ``_conv_names``: trunk, then det,
    loc and lm heads (conv1, conv2), then the refine branch. Names are the
    port's (``det.det_conv1`` for JAX's ``det/det_conv1``)."""
    sd = DenseBox(cfg, device="meta").state_dict()
    return {k[:-len(".weight")]: tuple(v.shape) for k, v in sd.items()
            if k.endswith(".weight")}


def conv_names(cfg: ModelCfg) -> List[str]:
    return list(conv_shapes(cfg))


def quant_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float OIHW weight -> (int8 weight in the kernel's (Cout, k, k, Cin)
    layout, per-output-channel float32 scale), as JAX's ``_quant_weight``:
    scale = max(|w|) / 127 per output channel, codes round(w / scale)."""
    w = w.to(torch.float32)
    s = (w.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    wq = torch.round(w / s[:, None, None, None]).clamp(-127, 127)
    return wq.to(torch.int8).permute(0, 2, 3, 1).contiguous(), s


def quant_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], int8 (a division, as JAX's
    ``_quant_act``: multiplying by the reciprocal would round differently)."""
    return torch.round(x.to(torch.float32) / scale).clamp(-127, 127).to(
        torch.int8)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool of an NHWC tensor of any dtype (int8 codes included)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def calibration_taps(state_dict, cfg: ModelCfg, images: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """The absmax of every conv's input over ``images`` (and ``__f4__``, the
    trunk output), from the bf16 walk of JAX's ``_forward(taps=...)``: each
    conv in bf16 followed by a separate bf16 bias add, the skip ``feat``
    concatenated, each head run on its own. On the images' device."""
    dev = images.device
    check_divisible(cfg, images)
    taps: Dict[str, torch.Tensor] = {}

    def conv(x, name, relu=True):
        taps[name] = x.abs().amax().to(torch.float32)
        w = state_dict[f"{name}.weight"].to(dev, GLUE)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=w.shape[-1] // 2)
        y = y.permute(0, 2, 3, 1) + state_dict[f"{name}.bias"].to(dev, GLUE)
        return torch.relu(y) if relu else y

    plan = trunk_plan(cfg)
    f3_tap = [n for k, n, _ in plan if k == "conv" and n.startswith("conv3")][-1]
    x, f3 = images.to(GLUE), None
    for kind, name, _ in plan:
        if kind == "conv":
            x = conv(x, name)
            if name == f3_tap:
                f3 = x
        elif kind in ("s2d", "s2d4"):
            x = space_to_depth(x, 2 if kind == "s2d" else 4)
        else:
            x = max_pool_2x2(x)
    taps["__f4__"] = x.abs().amax().to(torch.float32)
    feat = torch.cat([f3, upsample2x_align_corners(x)], dim=-1)

    def head(prefix):
        h = conv(feat, f"{prefix}.{prefix}_conv1")
        return conv(h, f"{prefix}.{prefix}_conv2", relu=False)

    score, _ = head("det"), head("loc")
    if cfg.num_landmarks:
        lm = head("lm")
        if cfg.use_refine:
            r = torch.cat([score, lm], dim=-1)
            r = conv(r, "refine_conv1")
            r = conv(r, "refine_conv2")
            conv(r, "refine_out", relu=False)
    return taps


@torch.no_grad()
def quantize_densebox(state_dict, cfg: ModelCfg, calib_images: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Calibrate activation scales on ``calib_images`` (NHWC float) and
    quantise every conv of the float ``state_dict`` (``DenseBox``'s names
    and layouts; float32, as ``from_flax`` and ``init_params`` give it, for
    the JAX package's weight codes).
    Returns the ``state_dict`` of ``QuantDenseBox(cfg)``, on the images'
    device: per conv ``w_q``, ``w_scale``, ``in_scale`` (max(absmax / 127,
    1e-12)) and ``bias``; and ``f4_scale``, the trunk output's scale, which
    the JAX package's int8-upsample knob reads and this chain does not.

    Raises ``ValueError`` if the head conv1 input scales differ: every head
    reads the same ``feat``, and the chain quantises it per head at that
    scale."""
    dev = calib_images.device
    taps = calibration_taps(state_dict, cfg, calib_images)
    sd = {}
    for name in conv_names(cfg):
        sd[f"{name}.w_q"], sd[f"{name}.w_scale"] = quant_weight(
            state_dict[f"{name}.weight"].to(dev))
        sd[f"{name}.in_scale"] = (taps[name] / 127.0).clamp_min(1e-12)
        sd[f"{name}.bias"] = state_dict[f"{name}.bias"].to(dev, torch.float32)
    sd["f4_scale"] = (taps["__f4__"] / 127.0).clamp_min(1e-12)
    heads = ["det", "loc"] + (["lm"] if cfg.num_landmarks else [])
    head_taps = [float(taps[f"{p}.{p}_conv1"]) for p in heads]
    if any(t != head_taps[0] for t in head_taps[1:]):
        raise ValueError(
            "calibration invariant violated: head conv1 input scales differ "
            f"({head_taps}) — the shared-feat quantize would be wrong")
    return sd


class QConv(nn.Module):
    """The quantised parameters of one conv, as buffers: ``w_q`` int8
    (Cout, k, k, Cin), ``w_scale`` (Cout,), ``in_scale`` () and ``bias``
    (Cout,) float32."""

    def __init__(self, cout: int, cin: int, k: int, device=None):
        super().__init__()
        self.register_buffer("w_q", torch.zeros((cout, k, k, cin),
                                                dtype=torch.int8, device=device))
        self.register_buffer("w_scale", torch.ones(cout, device=device))
        self.register_buffer("in_scale", torch.ones((), device=device))
        self.register_buffer("bias", torch.zeros(cout, device=device))


class QuantDenseBox(nn.Module):
    """The int8 DenseBox, eval forward, following JAX's ``_forward_fused``
    line by line.

    ``backend='fused'`` (JAX ``'pallas'``) runs each conv as one
    ``qconv_int8`` with its epilogue; ``backend='hybrid'`` (JAX
    ``'hybrid'``) runs the int32-accumulator ``qconv_int8`` and then
    ``requant_epilogue``. The two compute the same values bit for bit.
    ``backend='xla'`` (JAX ``'xla'``, that package's default) is another
    chain: each conv quantises its bf16 input, runs the int32-accumulator
    ``qconv_int8`` and dequantises ``f32(acc) * (in_scale * w_scale) +
    bias`` (a product, then a sum, each rounded) to bf16 before ReLU; the
    heads' input is quantised once, at ``det_conv1``'s scale.

    Call with NHWC float images (H, W divisible by ``cfg.min_divisor``);
    returns a dict of stride-4 NHWC float32 maps: ``score``, ``loc`` and,
    with landmarks, ``lm`` and ``refined``. State names follow the JAX
    qparams tree with '.' for '/' (``det.det_conv1.w_q``, ``f4_scale``).
    All state is buffers; the module has no parameters. Built on the card
    unless ``device`` names another device.

    The epilogue vectors of each conv (``in_scale * w_scale``, the bias and
    ``1 / in_scale`` of the conv that reads its output, each as a contiguous
    (Cout,) tensor) depend on the state alone, so they are computed at the
    first forward after the state was loaded or moved, and kept (not while
    torch traces the forward: ``utils/constants.py``). After changing a
    buffer in place, call ``refresh_constants()``.
    """

    def __init__(self, cfg: ModelCfg, backend: str = "fused", device=None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.backend = backend
        self.plan = trunk_plan(cfg)
        self.convs = [n for k, n, _ in self.plan if k == "conv"]
        self.f3_tap = [n for n in self.convs if n.startswith("conv3")][-1]
        self._q: Dict[str, QConv] = {}
        for name, (cout, cin, k, _) in conv_shapes(cfg).items():
            q = QConv(cout, cin, k, device=device)
            parent, _, leaf = name.rpartition(".")
            if parent:
                if not hasattr(self, parent):
                    self.add_module(parent, nn.ModuleDict())
                getattr(self, parent)[leaf] = q
            else:
                self.add_module(leaf, q)
            self._q[name] = q
        self.register_buffer("f4_scale", torch.ones((), device=device))
        self._consts: Dict[Tuple[str, Optional[str]], tuple] = {}

    def refresh_constants(self) -> None:
        """Forget the cached epilogue vectors; the next forward recomputes
        them from the buffers."""
        self._consts = {}

    def load_state_dict(self, *args, **kwargs):
        self.refresh_constants()
        return super().load_state_dict(*args, **kwargs)

    def _apply(self, *args, **kwargs):       # .to(), .cuda(), .cpu()
        self.refresh_constants()
        return super()._apply(*args, **kwargs)

    def _conv_constants(self, name: str, nxt: Optional[str]):
        """(scale, bias, out_scale) of conv ``name`` whose output conv
        ``nxt`` reads (``out_scale`` None without one): (Cout,) float32."""
        consts = self._consts.get((name, nxt))
        if consts is None:
            q = self._q[name]
            cout, dev = q.w_q.shape[0], q.w_q.device
            out_scale = (channel_vector(1.0 / self._q[nxt].in_scale, cout, dev)
                         if nxt is not None else None)
            consts = (channel_vector(q.in_scale * q.w_scale, cout, dev),
                      channel_vector(q.bias, cout, dev), out_scale)
            if is_plain(consts[0]):     # never the fake tensors of a trace
                self._consts[(name, nxt)] = consts
        return consts

    def _conv(self, x_q: torch.Tensor, name: str, nxt: Optional[str], *,
              relu: bool = True) -> torch.Tensor:
        """x_q int8 at in_scale(name) -> int8 at in_scale(nxt), or float32
        when ``nxt`` is None."""
        w_q = self._q[name].w_q
        scale, bias, out_scale = self._conv_constants(name, nxt)
        if self.backend == "hybrid":
            acc = qconv_int8(x_q, w_q, None, None, out="int32")
            return requant_epilogue(acc, scale, bias, out_scale, relu=relu)
        return qconv_int8(x_q, w_q, scale, bias, out_scale, relu=relu)

    def _conv_xla(self, x: Optional[torch.Tensor], name: str, *,
                  relu: bool = True, x_q: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """JAX ``_forward``'s int8 conv: bf16 x (or its codes ``x_q``) ->
        bf16."""
        q = self._q[name]
        if x_q is None:
            x_q = quant_act(x, q.in_scale)
        scale, bias, _ = self._conv_constants(name, None)
        acc = qconv_int8(x_q, q.w_q, None, None, out="int32")
        y = (acc.to(torch.float32) * scale + bias).to(GLUE)
        return torch.relu(y) if relu else y

    def _forward_xla(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x, f3 = images.to(GLUE), None
        for kind, name, _ in self.plan:
            if kind == "conv":
                x = self._conv_xla(x, name)
                if name == self.f3_tap:
                    f3 = x
            elif kind in ("s2d", "s2d4"):
                x = space_to_depth(x, 2 if kind == "s2d" else 4)
            else:
                x = max_pool_2x2(x)
        feat = torch.cat([f3, upsample2x_align_corners(x)], dim=-1)
        feat_q = quant_act(feat, self._q["det.det_conv1"].in_scale)

        def head(prefix):
            h = self._conv_xla(None, f"{prefix}.{prefix}_conv1", x_q=feat_q)
            return self._conv_xla(h, f"{prefix}.{prefix}_conv2", relu=False)

        out = {"score": head("det").float(), "loc": head("loc").float()}
        if cfg.num_landmarks:
            lm = head("lm")
            out["lm"] = lm.float()
            if cfg.use_refine:
                r = torch.cat([out["score"].to(GLUE), lm], dim=-1)
                r = self._conv_xla(r, "refine_conv1")
                r = self._conv_xla(r, "refine_conv2")
                out["refined"] = self._conv_xla(r, "refine_out",
                                                relu=False).float()
        return out

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        check_divisible(cfg, images)
        if self.backend == "xla":
            return self._forward_xla(images)
        in_scale = {n: q.in_scale for n, q in self._q.items()}
        nxt = dict(zip(self.convs[:-1], self.convs[1:]))
        # trunk: quantise the image once, then int8 from conv to conv
        x_q = quant_act(images, in_scale[self.convs[0]])
        f3_q = None
        for kind, name, _ in self.plan:
            if kind == "conv":
                x_q = self._conv(x_q, name, nxt.get(name))
                if name == self.f3_tap:
                    f3_q = x_q          # int8 at in_scale(conv4_1)
            elif kind in ("s2d", "s2d4"):
                x_q = space_to_depth(x_q, 2 if kind == "s2d" else 4)
            else:
                # max-pool commutes with the monotonic requant: pooling the
                # int8 codes equals pooling in float, then quantising
                x_q = max_pool_2x2(x_q)
        f4 = x_q.to(GLUE)               # the last trunk conv emitted f32
        f3 = (f3_q.to(torch.float32) * in_scale[nxt[self.f3_tap]]).to(GLUE)
        feat = torch.cat([f3, upsample2x_align_corners(f4)], dim=-1)

        def head(prefix):
            c1, c2 = f"{prefix}.{prefix}_conv1", f"{prefix}.{prefix}_conv2"
            h_q = self._conv(quant_act(feat, in_scale[c1]), c1, c2)
            return self._conv(h_q, c2, None, relu=False)

        out = {"score": head("det"), "loc": head("loc")}
        if cfg.num_landmarks:
            lm = out["lm"] = head("lm")
            if cfg.use_refine:
                r = torch.cat([out["score"].to(GLUE), lm.to(GLUE)], dim=-1)
                r_q = quant_act(r, in_scale["refine_conv1"])
                r_q = self._conv(r_q, "refine_conv1", "refine_conv2")
                r_q = self._conv(r_q, "refine_conv2", "refine_out")
                out["refined"] = self._conv(r_q, "refine_out", None,
                                            relu=False)
        return out
