"""DenseBox model in PyTorch: eval and train forward.

Port of ``densebox_tpu/models/densebox.py`` (the reference it is tested
against): the VGG-FCN trunk of ``trunk_plan``, the x2 align-corners skip
upsample, the fused det/loc[/lm] heads and the landmark refine branch.

Only the JAX package's resolved defaults exist here, with no knob: skip
fusion 'split' (each head conv1 is two sliced-weight products over f3 and
the upsampled f4, the concat never built), head_impl 'fused' (one conv1
product over the Cout-concatenated weights, one block-diagonal conv2, one
dropout draw over the fused hidden tensor) and, in training, the fused
relu+dropout whose backward reads only its output (``fused_relu_dropout``),
its keep mask drawn from random bytes where the rate is a multiple of 1/256.
The max-pool is torch's.

Layouts: the public forward takes NHWC images and returns NHWC float32 maps,
as the JAX model does. Inside, the trunk runs on NCHW tensors in
``channels_last`` memory, which is NHWC in memory, so every switch between
the two views is a free ``permute``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from densebox_tpu_torch.config import ModelCfg
from densebox_tpu_torch.device import reference_precision, resolve_device
from densebox_tpu_torch.ops.decode import div
from densebox_tpu_torch.ops.upsample import upsample2x_align_corners
from densebox_tpu_torch.utils.logging import span

# (kind, name, base_width): the paper trunk, VGG19 through conv4_4.
TRUNK_PLAN = (
    ("conv", "conv1_1", 64), ("conv", "conv1_2", 64), ("pool", "pool1", 0),
    ("conv", "conv2_1", 128), ("conv", "conv2_2", 128), ("pool", "pool2", 0),
    ("conv", "conv3_1", 256), ("conv", "conv3_2", 256),
    ("conv", "conv3_3", 256), ("conv", "conv3_4", 256),   # -> f3 (stride 4)
    ("pool", "pool3", 0),
    ("conv", "conv4_1", 512), ("conv", "conv4_2", 512),
    ("conv", "conv4_3", 512), ("conv", "conv4_4", 512),   # -> f4 (stride 8)
)


def trunk_plan(cfg: ModelCfg) -> Tuple[Tuple[str, str, int], ...]:
    """Trunk topology for a config (same plan as the JAX model): the paper
    config is TRUNK_PLAN; stem 's2d' replaces pool1 by space-to-depth(2),
    stem 's2d4' runs the whole trunk at stride 4 after space-to-depth(4),
    and ``trunk_depth`` sets the convs per conv3/conv4 block."""
    if cfg.stem == "conv" and cfg.trunk_depth == 4:
        return TRUNK_PLAN
    plan = []
    if cfg.stem == "s2d4":
        plan += [("s2d4", "s2d4", 0),
                 ("conv", "conv1_1", 64), ("conv", "conv1_2", 64),
                 ("conv", "conv2_1", 128), ("conv", "conv2_2", 128)]
    elif cfg.stem == "s2d":
        plan += [("s2d", "s2d", 0),
                 ("conv", "conv1_1", 64), ("conv", "conv1_2", 64),
                 ("conv", "conv2_1", 128), ("conv", "conv2_2", 128),
                 ("pool", "pool2", 0)]
    else:
        plan += [("conv", "conv1_1", 64), ("conv", "conv1_2", 64),
                 ("pool", "pool1", 0),
                 ("conv", "conv2_1", 128), ("conv", "conv2_2", 128),
                 ("pool", "pool2", 0)]
    d = cfg.trunk_depth
    plan += [("conv", f"conv3_{i + 1}", 256) for i in range(d)]
    plan += [("pool", "pool3", 0)]
    plan += [("conv", f"conv4_{i + 1}", 512) for i in range(d)]
    return tuple(plan)


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, C*r*r), channels ordered (dy, dx, c) as
    in the JAX model. ``F.pixel_unshuffle`` orders them (c, dy, dx), which
    would scramble the s2d stems' conv1_1 weights."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, c * r * r)


# (device, dtype, shape, weight shape, padding) of a convolution's batch ->
# whether cuDNN computes an image of it the same way in every slot
_slot_safe: Dict[tuple, bool] = {}
_slot_lock = threading.Lock()


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def slot_safe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              padding) -> bool:
    """Whether ``F.conv2d`` of a batch shaped like ``x`` (shape, dtype,
    device; the model's convs take channels_last batches) gives an image
    the same bits in every slot of the batch: one seeded random image in
    every slot must come out with every slot equal. Found once per shape
    and kept, so that a trace for export finds what the live call before
    it found. cuDNN's bfloat16 kernels on the H100 fail it for some shapes
    (the 512-channel convs at 43 x 57 and 22 x 29 with B=8, pyramid levels
    0.7071 and 0.3536 of a 480 x 640 canvas; at 60 x 80 with B=2 and B=64
    but not B=8): an image's sums there run in an order that depends on its
    slot, whatever the memory format, cuDNN's benchmark or deterministic
    mode, or a zero column that makes the width even."""
    key = (x.device, x.dtype, tuple(x.shape), tuple(w.shape), padding)
    with _slot_lock:
        if key not in _slot_safe:
            gen = torch.Generator(device=x.device).manual_seed(0)
            one = torch.randn((1,) + tuple(x.shape[1:]), generator=gen,
                              device=x.device).to(x.dtype)
            probe = torch.empty_like(x)
            probe.copy_(one.expand_as(x))
            y = _bits(F.conv2d(probe, w, b, padding=padding))
            _slot_safe[key] = bool((y == y[:1]).all())
        return _slot_safe[key]


def split_by_image(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   padding) -> bool:
    """Whether ``DenseBox._conv`` runs the batch ``x`` one image a call:
    without autograd (detect, serve, export), on the card, where
    ``slot_safe`` finds that cuDNN's batched call would compute an image
    differently by its slot. A served image's result then does not depend
    on which requests share its device call; training, the CPU and every
    slot-safe shape keep the one batched call."""
    return (x.is_cuda and x.shape[0] > 1 and not torch.is_grad_enabled()
            and not slot_safe(x, w, b, padding))


def check_divisible(cfg: ModelCfg, images: torch.Tensor) -> None:
    """Raise unless the NHWC images' H and W are multiples of
    ``cfg.min_divisor`` (the trunk's pooling)."""
    if images.shape[1] % cfg.min_divisor or images.shape[2] % cfg.min_divisor:
        raise ValueError(f"input H,W must be divisible by {cfg.min_divisor}, "
                         f"got {tuple(images.shape)}")


def _nhwc_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) channels_last -> (B*H*W, C) rows (a view when the
    tensor really is channels_last)."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def dropout_plan(rate: float) -> Tuple[int, float]:
    """(byte threshold, keep probability) of a dropout rate. Where ``rate``
    is a multiple of 1/256 inside (0, 1), one random byte per element
    decides: keep iff byte >= threshold = rate * 256 (a quarter of the random
    bits of a float draw). Any other rate has threshold 0: the mask is drawn
    from uniforms at the exact rate."""
    thresh = int(round(rate * 256))
    if 0 < thresh < 256 and thresh / 256.0 == rate:
        return thresh, 1.0 - thresh / 256.0
    return 0, 1.0 - rate


def dropout_keep_mask(shape, rate: float, generator: torch.Generator
                      ) -> torch.Tensor:
    """Draw the bool keep mask of ``dropout_plan(rate)`` on the generator's
    device: byte >= threshold, or u < keep probability."""
    thresh, keep_prob = dropout_plan(rate)
    if thresh:
        byts = torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=generator.device, generator=generator)
        return byts >= thresh
    return torch.rand(shape, device=generator.device,
                      generator=generator) < keep_prob


class _FusedReluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, keep, keep_prob):
        y = torch.where(keep, div(torch.relu(x), keep_prob), 0)
        ctx.save_for_backward(y)
        ctx.keep_prob = keep_prob
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return torch.where(y > 0, div(g, ctx.keep_prob), 0), None, None


def fused_relu_dropout(x: torch.Tensor, keep: torch.Tensor, keep_prob: float
                       ) -> torch.Tensor:
    """``where(keep, relu(x) / keep_prob, 0)`` for a bool ``keep`` of x's
    shape. Backward is ``g * (y > 0) / keep_prob`` from the output y alone
    (y > 0 iff kept and x > 0), so neither x nor the mask is saved: y is the
    only tensor kept for backward, and the next product keeps it anyway."""
    return _FusedReluDropout.apply(x, keep, keep_prob)


class DenseBox(nn.Module):
    """The DenseBox FCN. Parameter names follow the Flax tree (``conv1_1``,
    ``det.det_conv1``, ``refine_out``, ...) so that
    ``models.convert.from_flax`` loads a JAX checkpoint as it is.

    Parameters are held in ``cfg.param_dtype`` and cast to
    ``cfg.compute_dtype`` where they are used, as in the JAX model: an
    optimizer then updates float32 weights under a bfloat16 forward. A
    bfloat16 server that never trains can set ``param_dtype="bfloat16"`` to
    hold the weights in bfloat16 and save the casts; the numbers are the
    same. Built on the card unless ``device`` names another device. A
    float32 forward runs in full float32 (``device.reference_precision``),
    as the reference's ``Precision.HIGHEST``.

    Call with NHWC images (H, W divisible by ``cfg.min_divisor``); returns a
    dict of stride-4 NHWC float32 maps: ``score`` (B, H/4, W/4, 1), ``loc``
    (..., 4) and, with landmarks, ``lm`` (..., L) and ``refined`` (..., 1);
    the refine branch runs under a ``model.refine`` span
    (``utils/logging.py``).
    ``train=True`` applies dropout (rate ``cfg.dropout_rate``) to the heads'
    hidden tensor, from ``generator`` (a ``torch.Generator`` on the images'
    device) or from a given bool ``dropout_keep`` mask of shape
    (B, H/4, W/4, heads * width). ``nn.Module.training`` is not read.

    Under tensor parallelism (``parallel/mesh.py``) each head's conv1 holds
    this rank's slice of its output channels and ``head_shards`` gathers
    the hidden tensor before conv2; a given ``dropout_keep`` then covers
    this rank's channels only.
    """

    def __init__(self, cfg: ModelCfg, device=None):
        super().__init__()
        self.cfg = cfg
        self.plan = trunk_plan(cfg)
        kw = dict(device=resolve_device(device),
                  dtype=getattr(torch, cfg.param_dtype))
        cin, c3 = 3, None
        for kind, name, width in self.plan:
            if kind == "conv":
                cout = cfg.scaled(width)
                self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1, **kw))
                cin = cout
                if name.startswith("conv3"):
                    c3 = cout
            elif kind in ("s2d", "s2d4"):
                cin *= 4 if kind == "s2d" else 16
        self.f3_tap = [n for k, n, _ in self.plan
                       if k == "conv" and n.startswith("conv3")][-1]
        feat = c3 + cin                     # f3 ++ upsampled f4 channels
        width = cfg.scaled(cfg.head_width)
        self.head_spec = [("det", 1), ("loc", 4)]
        if cfg.num_landmarks:
            self.head_spec.append(("lm", cfg.num_landmarks))
        for pfx, oc in self.head_spec:
            self.add_module(pfx, nn.ModuleDict({
                f"{pfx}_conv1": nn.Conv2d(feat, width, 1, **kw),
                f"{pfx}_conv2": nn.Conv2d(width, oc, 1, **kw)}))
        if cfg.num_landmarks and cfg.use_refine:
            rw = cfg.refine_width
            self.refine_conv1 = nn.Conv2d(1 + cfg.num_landmarks, rw, 3,
                                          padding=1, **kw)
            self.refine_conv2 = nn.Conv2d(rw, rw, 3, padding=1, **kw)
            self.refine_out = nn.Conv2d(rw, 1, 1, **kw)
        self.to(memory_format=torch.channels_last)
        # set by parallel/mesh.py when the heads' conv1 output channels are
        # sharded over model ranks (tensor parallelism); None: all here
        self.head_shards = None

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """``conv`` with its parameters cast to x's dtype: one batched
        call, or one call an image where ``split_by_image`` says so."""
        w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
        if split_by_image(x, w, b, conv.padding):
            return torch.cat([F.conv2d(xi, w, b, padding=conv.padding)
                              for xi in x.split(1)]).contiguous(
                memory_format=torch.channels_last)
        return F.conv2d(x, w, b, padding=conv.padding)

    def _heads(self, f3: torch.Tensor, up: torch.Tensor, train: bool,
               generator, dropout_keep) -> torch.Tensor:
        """All heads as one conv1 product (split over f3 / up), one relu (in
        training one relu+dropout) and one block-diagonal conv2 product. f3
        channels_last NCHW, up NHWC. Returns (B, h, w, sum(out)) NHWC in the
        compute dtype."""
        dtype = up.dtype
        heads = [getattr(self, pfx) for pfx, _ in self.head_spec]
        conv1 = [h[f"{p}_conv1"] for h, (p, _) in zip(heads, self.head_spec)]
        conv2 = [h[f"{p}_conv2"] for h, (p, _) in zip(heads, self.head_spec)]
        k1 = torch.cat([c.weight[:, :, 0, 0] for c in conv1]).to(dtype)
        b1 = torch.cat([c.bias for c in conv1]).to(dtype)    # k1 (n*W, Cin)
        ca = f3.shape[1]
        a, u = _nhwc_rows(f3), up.reshape(-1, up.shape[-1])
        tp = self.head_shards
        if tp is not None:      # this rank's conv1 channels of every head
            a, u = tp.enter(a), tp.enter(u)
        # bias and the second partial product accumulate in the GEMM epilogue
        y = torch.addmm(b1, a, k1[:, :ca].t())
        y = y.addmm_(u, k1[:, ca:].t())
        if train and self.cfg.dropout_rate > 0.0:
            if dropout_keep is None:
                if generator is None:
                    raise ValueError("DenseBox: a train forward with dropout "
                                     "needs a generator or a dropout_keep mask")
                dropout_keep = dropout_keep_mask(
                    y.shape, self.cfg.dropout_rate, generator)
            y = fused_relu_dropout(y, dropout_keep.reshape(y.shape),
                                   dropout_plan(self.cfg.dropout_rate)[1])
        else:
            y = y.relu_()
        if tp is not None:
            y = tp.gather(y, len(heads))
        k2 = torch.block_diag(*[c.weight[:, :, 0, 0] for c in conv2]).to(dtype)
        b2 = torch.cat([c.bias for c in conv2]).to(dtype)
        z = torch.addmm(b2, y, k2.t())
        b, _, h, w = f3.shape
        return z.reshape(b, h, w, -1)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_keep: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        with reference_precision(self.cfg.compute_dtype):
            return self._forward(images, train, generator, dropout_keep)

    def _forward(self, images, train, generator, dropout_keep):
        cfg = self.cfg
        check_divisible(cfg, images)
        dtype = getattr(torch, cfg.compute_dtype)
        x = images.to(dtype).permute(0, 3, 1, 2)   # channels_last NCHW view
        f3 = None
        for kind, name, _ in self.plan:
            if kind == "conv":
                x = torch.relu(self._conv(getattr(self, name), x))
                if name == self.f3_tap:
                    f3 = x
            elif kind in ("s2d", "s2d4"):
                r = 2 if kind == "s2d" else 4
                x = space_to_depth(x.permute(0, 2, 3, 1), r).permute(0, 3, 1, 2)
            else:
                x = F.max_pool2d(x, 2, 2)
        up = upsample2x_align_corners(x.permute(0, 2, 3, 1))
        z = self._heads(f3, up, train, generator, dropout_keep)
        score, loc = z[..., 0:1], z[..., 1:5]
        out = {"score": score.float(), "loc": loc.float()}
        if cfg.num_landmarks:
            lm = z[..., 5:5 + cfg.num_landmarks]
            out["lm"] = lm.float()
            if cfg.use_refine:
                with span("model.refine"):
                    r = torch.cat([score, lm], dim=-1).permute(0, 3, 1, 2)
                    r = torch.relu(self._conv(self.refine_conv1, r))
                    r = torch.relu(self._conv(self.refine_conv2, r))
                    out["refined"] = self._conv(self.refine_out, r).permute(
                        0, 2, 3, 1).float()
        return out
