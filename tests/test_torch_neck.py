"""The int8 neck (``ops/kernels/neck.py``): its plain version against the
eager sequence of ``QuantDenseBox._forward_fused`` it replaced, the kernel's
arithmetic from the upsample's two-tap tables against the plain version, the
exported graph (one node a scale), and on the card the CUDA kernel against
the plain version and its launches per detect call.

The tests marked ``gpu`` need a CUDA card and skip without one. No jax is
imported, so on the machine with the card they run as

    python -m pytest --noconftest -q tests/test_torch_neck.py
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from densebox_tpu_torch import LabelCfg, ModelCfg, kitti_vehicle, malf_face
from densebox_tpu_torch.export import export_detect_program
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.infer.detector import pyramid_shapes
from densebox_tpu_torch.models import (QuantDenseBox, init_params,
                                       quantize_densebox)
from densebox_tpu_torch.models.densebox import upsample2x_align_corners
from densebox_tpu_torch.models.quant import GLUE, quant_act
from densebox_tpu_torch.ops.kernels import launch_counts
from densebox_tpu_torch.ops.kernels import neck as kneck

CPU = torch.device("cpu")


def f4_shapes(preset, hw=(480, 640)):
    """(H/8, W/8) of conv4_4's output at each scale of a preset's pyramid."""
    return [(h // 8, w // 8)
            for h, w, _, _ in pyramid_shapes(*hw, preset.infer.scales)]


KITTI = f4_shapes(kitti_vehicle())      # 30x40, 43x57, 60x80, 85x114
MALF = f4_shapes(malf_face())           # 22x29 first


def neck_case(seed, b, h4, w4, c3, c4, device=CPU):
    """f3 codes over the whole int8 range, f4 mostly a ReLU's output with a
    few negative values, and a scale of each kind: f3's arbitrary, the
    output's a power of two (so that many quotients are exact halves and
    round to even) or arbitrary."""
    g = torch.Generator(device=device).manual_seed(seed)
    f3 = torch.randint(-127, 128, (b, 2 * h4, 2 * w4, c3), generator=g,
                       device=device, dtype=torch.int8)
    f4 = torch.rand((b, h4, w4, c4), generator=g, device=device) * 5.0
    f4 = torch.where(torch.rand(f4.shape, generator=g, device=device) < 0.3,
                     torch.zeros((), device=device), f4) - 0.05
    f3_scale = torch.tensor(0.0173, device=device)
    out_scales = [torch.tensor(2.0 ** -5, device=device),
                  torch.tensor(0.0219, device=device)]
    return f3, f4, f3_scale, out_scales


def old_sequence(f3_q, f4, f3_scale, head_scales):
    """What ``_forward_fused`` ran before the neck was one operator: the
    feature map once, then ``quant_act`` per head."""
    f4 = f4.to(GLUE)
    f3 = (f3_q.to(torch.float32) * f3_scale).to(GLUE)
    feat = torch.cat([f3, upsample2x_align_corners(f4)], dim=-1)
    return [quant_act(feat, s) for s in head_scales]


def taps_model(f3_q, f4, f3_scale, out_scale):
    """The kernel's arithmetic in torch: each upsampled value the sum of
    its two taps from ``interp_taps``, each step rounded as the kernel
    rounds it, and the f3 codes through the same steps as the plain
    version."""
    def bf(t):
        return t.to(torch.bfloat16).float()

    def taps(n_in, n_out):
        t = kneck.interp_taps(n_in, n_out, f4.device)
        lo = t[0].long()
        return (lo, (lo + 1).clamp(max=n_in - 1), t[1].view(torch.float32),
                t[2].view(torch.float32))

    _, h4, w4, _ = f4.shape
    x = bf(f4)
    lo, hi, wa, wb = taps(w4, 2 * w4)
    x = bf(wa[:, None] * x[:, :, lo] + wb[:, None] * x[:, :, hi])
    lo, hi, wa, wb = taps(h4, 2 * h4)
    x = bf(wa[:, None, None] * x[:, lo] + wb[:, None, None] * x[:, hi])
    f3 = bf(f3_q.float() * f3_scale)
    feat = torch.cat([f3, x], dim=-1)
    return torch.round(feat / out_scale).clamp(-127, 127).to(torch.int8)


# the four kitti scales at B = 2, an odd f4 width, and a single f4 row or
# column (interp_matrix_align_corners' n_in == 1 row)
CPU_SHAPES = ([(2, h4, w4) for h4, w4 in KITTI]
              + [(1, 3, 5), (2, 1, 1), (1, 1, 3), (1, 4, 1)])


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=str)
def test_plain_neck_equals_old_sequence(shape):
    f3, f4, s3, heads = neck_case(sum(shape), *shape, 16, 32)
    want = old_sequence(f3, f4, s3, heads)
    for s, w in zip(heads, want):
        got = kneck.int8_neck(f3, f4, s3, s)
        assert got.dtype == torch.int8 and got.shape == w.shape
        assert torch.equal(got, w)


@pytest.mark.parametrize("shape", CPU_SHAPES, ids=str)
def test_taps_model_equals_plain_neck(shape):
    """The upsample as two taps a row and column, from the tables the
    kernel reads, gives the dense products' codes bit for bit."""
    f3, f4, s3, heads = neck_case(sum(shape) + 1, *shape, 16, 32)
    for s in heads:
        want = kneck.neck_reference(f3, f4, s3, s)
        assert torch.equal(taps_model(f3, f4, s3, s), want)


@pytest.mark.parametrize("n_in", [1, 2, 3, 30, 43, 57, 85, 114])
def test_interp_taps_hold_the_matrix(n_in):
    """Two taps a row rebuild the bf16 interpolation matrix exactly; the
    first index stays inside the input, and the second only steps past the
    first where there is a second input."""
    t = kneck.interp_taps(n_in, 2 * n_in, CPU)
    assert t.dtype == torch.int32 and t.shape == (3, 2 * n_in)
    lo = t[0].long()
    assert lo.min() >= 0 and lo.max() <= max(n_in - 2, 0)
    assert torch.all(lo[1:] - lo[:-1] >= 0)
    wa, wb = t[1].view(torch.float32), t[2].view(torch.float32)
    assert torch.equal(wa[0], torch.tensor(1.0)) and wb[0] == 0
    if n_in == 1:
        assert torch.all(wb == 0)


def _int8_model(cfg, images, backend="fused", device=CPU):
    model = QuantDenseBox(cfg, backend=backend, device=device)
    model.load_state_dict(quantize_densebox(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg,
        images.to(device)))
    return model.eval()


def test_export_holds_one_neck_node_per_scale():
    """An int8 detect program at kitti's four scales: one ``int8_neck``
    node a scale, and no division, rounding or concat left over the heads'
    input (the quantise that each head ran)."""
    cfg = ModelCfg(width_mult=0.125)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 96, 128, 3)
                         .astype(np.float32))
    model = _int8_model(cfg, x)
    infer = dataclasses.replace(kitti_vehicle().infer, score_thresh=-1e9,
                                topk_per_scale=64, pre_nms_topk=128,
                                max_dets=16)
    ep = export_detect_program(model, infer, LabelCfg(), 2, (96, 128),
                               device="cpu")
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    necks = [n for n in nodes
             if str(n.target).startswith("densebox.int8_neck")]
    assert len(necks) == len(infer.scales) == 4
    feat_c = cfg.scaled(256) + cfg.scaled(512)
    for n in nodes:
        name = str(n.target)
        if any(op in name for op in ("aten.div", "aten.round", "aten.cat")):
            assert n.meta["val"].shape[-1] != feat_c, name
    with torch.no_grad():
        want = detect_batch(model, x, infer, LabelCfg())
        got = ep.module()(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_unequal_head_scales_neck_once_per_scale():
    """A state whose heads' conv1 scales differ (``quantize_densebox``
    never makes one) runs the neck once per distinct scale, each head at
    its own, and gives the old per-head quantise's maps; the grouping is
    read once per state and forgotten when the state changes."""
    cfg = ModelCfg(width_mult=0.125, num_landmarks=3)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 64, 96, 3)
                         .astype(np.float32))
    model = _int8_model(cfg, x)
    with torch.no_grad():
        same = model(x)
    assert model._neck_groups_of_state() == [
        ["det.det_conv1", "loc.loc_conv1", "lm.lm_conv1"]]
    sd = model.state_dict()
    sd["loc.loc_conv1.in_scale"] = sd["loc.loc_conv1.in_scale"] * 1.5
    model.load_state_dict(sd)
    calls = []
    real = kneck.neck_reference

    def counted(f3_q, f4, f3_scale, out_scale):
        calls.append(float(out_scale))
        return real(f3_q, f4, f3_scale, out_scale)

    with mock.patch.object(kneck, "neck_reference", counted), \
            torch.no_grad():
        got = model(x)
    assert model._neck_groups_of_state() == [
        ["det.det_conv1", "lm.lm_conv1"], ["loc.loc_conv1"]]
    assert len(calls) == 2 and calls[0] != calls[1]

    # the old path: the feature map quantised once per head at its scale
    def old_neck(f3_q, f4, f3_scale, out_scale):
        calls.append(float(out_scale))
        return old_sequence(f3_q, f4, f3_scale, [out_scale])[0]

    per_head = [[f"{p}.{p}_conv1"] for p in model.heads]
    with mock.patch.object(QuantDenseBox, "_neck_groups_of_state",
                           lambda self: per_head), \
            mock.patch.object(kneck, "neck_reference", old_neck), \
            torch.no_grad():
        want = model(x)
    assert len(calls) == 2 + 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["score"], same["score"])
    assert not torch.equal(got["loc"], same["loc"])


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (numpy has no fused multiply-add):
    the float64 product is exact, a two-sum keeps the sum's remainder, and a
    sum that lands on a float32 midpoint rounds toward that remainder."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    up = np.where(s > r64, np.float32(np.inf), np.float32(-np.inf))
    other = np.nextafter(r, up.astype(np.float32))
    mid = ((r64 + other.astype(np.float64)) / 2 == s) & (err != 0)
    return np.where(mid & ((other > r) == (err > 0)), other, r)


def quantise_model(v, s):
    """csrc/neck.cu's quantise in numpy: the quotient from y = RN(1 / s) and
    one correction (the remainder exact in a fused multiply-add), then the
    clip and a round half to even by adding 1.5 * 2^23."""
    y = np.float32(1) / s
    q0 = np.clip(v * y, np.float32(-128), np.float32(128))
    q = fma32(np.full_like(q0, -s), q0, v)
    q = fma32(q, np.full_like(q0, y), q0)
    c = np.clip(q, np.float32(-127), np.float32(127))
    return (c + np.float32(12582912.0)) - np.float32(12582912.0), q


def bf16_values():
    """Every finite bfloat16 value, as float32."""
    v = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)]


SCALES = np.concatenate([
    np.random.RandomState(0).uniform(1e-4, 0.1, 20),
    10.0 ** np.random.RandomState(1).uniform(-12, 3, 20),
    2.0 ** np.arange(-40, 10, 5), [1e-12, 0.0219, 0.0173, 1 / 127]]
).astype(np.float32)


def test_quantise_without_a_division():
    """The kernel's quotient is the correctly rounded one wherever it can
    move a code (|v / s| above 2^-60; below, the remainder underflows and
    the code is 0 either way), so its codes are quant_act's over every
    finite bfloat16 value at every scale tried."""
    v = bf16_values()
    with np.errstate(over="ignore", invalid="ignore"):
        for s in SCALES:
            want = v / s
            codes, q = quantise_model(v, s)
            np.testing.assert_array_equal(
                codes, np.clip(np.round(want), -127, 127), err_msg=str(s))
            sure = np.abs(want) >= 2.0 ** -60
            sure &= np.abs(want) <= 128
            np.testing.assert_array_equal(q[sure], want[sure], err_msg=str(s))


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


# kitti's four scales at B = 8 and 64 and malf's five at B = 8, full width;
# an odd width and single rows and columns; widths that are no multiple of
# 16 (a thread owns 8 channels)
CARD_SHAPES = ([(b, h4, w4, 256, 512) for b in (8, 64) for h4, w4 in KITTI]
               + [(8, h4, w4, 256, 512) for h4, w4 in MALF]
               + [(2, 3, 5, 32, 64), (3, 1, 1, 16, 16), (2, 1, 7, 32, 32),
                  (2, 9, 1, 16, 48), (2, 11, 13, 24, 40), (1, 5, 6, 8, 8)])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_neck_kernel_matches_plain_version(cuda, shape):
    f3, f4, s3, heads = neck_case(sum(shape), *shape, device=cuda)
    for s in heads:
        before = kneck.launches
        got = kneck.int8_neck(f3, f4, s3, s)
        torch.cuda.synchronize()
        assert kneck.launches == before + 1
        want = kneck.neck_reference(f3, f4, s3, s)
        assert got.dtype == want.dtype == torch.int8
        assert torch.equal(got, want), s
        del got, want
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_neck_kernel_quantises_every_bf16_value(cuda):
    """Every finite bfloat16 value as f4 (a single f4 row and column: each
    output is its input) at every scale of ``SCALES``."""
    v = torch.from_numpy(bf16_values()).to(cuda)
    f4 = torch.cat([v, torch.zeros(65536 - v.numel(), device=cuda)])
    f4 = f4.reshape(64, 1, 1, 1024)
    f3 = torch.randint(-127, 128, (64, 2, 2, 16), device=cuda,
                       dtype=torch.int8)
    for s in SCALES:
        s = torch.tensor(float(s), device=cuda)
        got = kneck.int8_neck(f3, f4, s, s)
        assert torch.equal(got, kneck.neck_reference(f3, f4, s, s)), float(s)


@pytest.mark.gpu
def test_neck_wrapper_checks(cuda):
    f3, f4, s3, (s, _) = neck_case(0, 1, 4, 6, 16, 32, device=cuda)
    with pytest.raises(TypeError):
        kneck.int8_neck(f3.float(), f4, s3, s)
    with pytest.raises(ValueError, match="H/2"):
        kneck.int8_neck(f3, f4[:, :3], s3, s)
    with pytest.raises(ValueError, match="multiples of 8"):
        kneck.int8_neck(f3[..., :12].contiguous(), f4, s3, s)
    with pytest.raises(ValueError, match="contiguous"):
        kneck.int8_neck(f3, torch.rand(1, 6, 4, 32, device=cuda)
                        .transpose(1, 2), s3, s)
    with pytest.raises(ValueError, match="scalar"):
        kneck.int8_neck(f3, f4, s3.double(), s)
    with pytest.raises(ValueError, match="different devices"):
        kneck.int8_neck(f3, f4, s3.cpu(), s)
    with pytest.raises(ValueError, match="no kernel"):
        kneck.int8_neck(f3.to("meta"), f4.to("meta"), s3.to("meta"),
                        s.to("meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["kitti", "malf"])
@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_neck_launches_per_scale(cuda, preset, backend):
    """A detect call launches the neck once per pyramid scale (three heads
    in malf's int8 model), twice where the heads' scales differ, and the
    card's maps equal the CPU's."""
    p = kitti_vehicle() if preset == "kitti" else malf_face()
    cfg = dataclasses.replace(p.model, width_mult=0.125)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 96, 128, 3)
                         .astype(np.float32))
    infer = dataclasses.replace(p.infer, score_thresh=-1e9,
                                topk_per_scale=64, pre_nms_topk=128,
                                max_dets=16, lm_topk=8)
    model = _int8_model(cfg, x, backend, device=cuda)
    on_cpu = _int8_model(cfg, x, backend)
    on_cpu.load_state_dict({k: v.cpu() for k, v in
                            model.state_dict().items()})
    scales = len(infer.scales)
    for skew in (1.0, 1.5):
        if skew != 1.0:
            sd = model.state_dict()
            sd["loc.loc_conv1.in_scale"] = sd["loc.loc_conv1.in_scale"] * skew
            model.load_state_dict(sd)
            on_cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
        before = launch_counts()["neck"]
        with torch.inference_mode():
            detect_batch(model, x.to(cuda), infer, p.label)
        torch.cuda.synchronize()
        assert launch_counts()["neck"] - before == scales * (
            1 if skew == 1.0 else 2)
        with torch.inference_mode():
            got = model(x.to(cuda))
            want = on_cpu(x)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k]), (skew, k)
