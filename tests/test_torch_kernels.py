"""The CUDA kernels (greedy NMS, int8 conv, requant epilogue, landmark window
gather, the two GT rasterizers, OHEM selection) against their plain PyTorch
versions, and a whole train step on the card taken twice.

These tests need a CUDA card (marker ``gpu``) and skip without one. This
file imports no jax, so on a machine with a card and no JAX they run as

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures jax). The box generators
here are shared with test_torch_decode_nms.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from densebox_tpu_torch.ops.kernels import labels as klabels
from densebox_tpu_torch.ops.kernels import nms as knms
from densebox_tpu_torch.ops.kernels import ohem as kohem
from densebox_tpu_torch.ops.kernels import qconv as kqconv
from densebox_tpu_torch.ops.kernels import requant as krequant
from densebox_tpu_torch.ops.kernels import window as kwindow
from densebox_tpu_torch.ops.nms import nms


def random_boxes(seed, b, k):
    rng = np.random.RandomState(seed)
    ctr = np.round(rng.uniform(0, 200, (b, k, 2)) / 25) * 25 \
        + rng.normal(0, 4, (b, k, 2))
    wh = rng.uniform(8, 60, (b, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.uniform(0.1, 1.0, (b, k)), 2).astype(np.float32)
    valid = rng.rand(b, k) > 0.2
    return boxes, scores, valid


def threshold_boxes(seed, b, k, integer_frac=0.5):
    """Pairs with IoU 0.5 in exact arithmetic: integer pairs, whose f32 IoU
    is exactly 0.5 under any rounding (not suppressed), and float pairs
    (shifted by a third of their width), which f32 rounds to either side."""
    rng = np.random.RandomState(seed)
    n = k // 2
    x, y = rng.uniform(0, 300, (2, b, n))
    w, h = rng.uniform(6, 60, (2, b, n))
    integer = rng.rand(b, n) < integer_frac
    x, y, h = (np.where(integer, np.round(v), v) for v in (x, y, h))
    w = np.where(integer, 3 * np.maximum(np.round(w / 3), 1), w)
    x, y, w, h = (v.astype(np.float32) for v in (x, y, w, h))
    s = w / np.float32(3)
    a = np.stack([x, y, x + w, y + h], -1)
    p = np.stack([x + s, y, x + w + s, y + h], -1)
    boxes = np.stack([a, p], 2).reshape(b, 2 * n, 4).astype(np.float32)
    scores = np.tile(np.linspace(1, 0.01, 2 * n, dtype=np.float32), (b, 1))
    return boxes, scores, np.ones((b, 2 * n), bool)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 256, 512, 1024])
def test_kernel_matches_plain_version(cuda, k):
    boxes, _, valid = random_boxes(k, 8, k)
    tb, tv = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    before = knms.launches
    got = knms.greedy_keep(tb, tv, 0.5)
    torch.cuda.synchronize()
    assert knms.launches == before + 1
    want = knms.greedy_keep_reference(tb, tv, 0.5)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_threshold_pairs_and_nms(cuda):
    for k in (256, 512):
        boxes, scores, valid = threshold_boxes(k, 8, k)
        args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
        want = nms(*args, iou_thresh=0.5, max_out=128, return_idx=True)
        got = nms(*[a.to(cuda) for a in args], iou_thresh=0.5, max_out=128,
                  return_idx=True)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_kernel_wrapper_checks(cuda):
    tb = torch.zeros(1, 1025, 4, device=cuda)
    with pytest.raises(ValueError, match="K <= 1024"):
        knms.greedy_keep(tb, torch.ones(1, 1025, dtype=torch.bool,
                                        device=cuda), 0.5)
    with pytest.raises(TypeError):
        knms.greedy_keep(tb[:, :8].half(), torch.ones(1, 8, dtype=torch.bool,
                                                      device=cuda), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        knms.greedy_keep(torch.zeros(1, 4, 8, device=cuda).transpose(1, 2),
                         torch.ones(1, 8, dtype=torch.bool, device=cuda), 0.5)


def _greedy_python(boxes, valid, thresh):
    """The greedy sweep written out pair by pair, in numpy float32."""
    f32 = np.float32
    keep = valid.copy()
    area = (np.maximum(boxes[:, 2] - boxes[:, 0], f32(0))
            * np.maximum(boxes[:, 3] - boxes[:, 1], f32(0)))
    for i in range(len(boxes)):
        if not keep[i]:
            continue
        for j in range(i + 1, len(boxes)):
            iw = np.maximum(np.minimum(boxes[i, 2], boxes[j, 2])
                            - np.maximum(boxes[i, 0], boxes[j, 0]), f32(0))
            ih = np.maximum(np.minimum(boxes[i, 3], boxes[j, 3])
                            - np.maximum(boxes[i, 1], boxes[j, 1]), f32(0))
            inter = iw * ih
            iou = inter / np.maximum(area[i] + area[j] - inter, f32(1e-9))
            if iou > f32(thresh):
                keep[j] = False
    return keep


@pytest.mark.parametrize("make", [random_boxes, threshold_boxes])
def test_reference_matches_pairwise_greedy(make):
    boxes, _, valid = make(3, 2, 96)
    got = knms.greedy_keep_reference(torch.from_numpy(boxes),
                                     torch.from_numpy(valid), 0.5)
    want = np.stack([_greedy_python(boxes[i], valid[i], 0.5)
                     for i in range(2)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.gpu
def test_detect_on_card_matches_cpu(cuda):
    """The whole det path (resize, forward, decode, kernel NMS) on the card
    against the CPU run, f32 with TF32 off; boxes to 1e-2 px (cuDNN's
    summation order moves maps by ~1e-6)."""
    from densebox_tpu_torch.config import InferCfg, LabelCfg, ModelCfg
    from densebox_tpu_torch.infer import make_detect_fn
    from densebox_tpu_torch.models import DenseBox, init_params

    cfg = ModelCfg(width_mult=0.25)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    infer = InferCfg(score_thresh=0.0, topk_per_scale=128, pre_nms_topk=256,
                     max_dets=32)
    img = torch.from_numpy(np.random.RandomState(0).rand(2, 96, 128, 3)
                           .astype(np.float32))
    out = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            model = DenseBox(cfg, device=dev)
            model.load_state_dict(sd)
            out[str(dev)] = {k: v.cpu() for k, v in make_detect_fn(
                model, infer, LabelCfg())(img.to(dev)).items()}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    want, got = out["cpu"], out["cuda"]
    assert want["valid"].any()
    assert torch.equal(got["valid"], want["valid"])
    v = want["valid"]
    torch.testing.assert_close(got["boxes"][v], want["boxes"][v],
                               atol=1e-2, rtol=0)
    torch.testing.assert_close(got["scores"][v], want["scores"][v],
                               atol=1e-4, rtol=0)


def qconv_case(seed, b, h, w, cin, cout, k):
    """Random int8 activations and weights over the whole code range, and
    epilogue vectors that put y at a few units, so that int8 outputs both
    round and clip. numpy arrays: x (B, H, W, Cin), w (Cout, k, k, Cin),
    scale, bias, out_scale (Cout,)."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    spread = 127.0 * 127.0 * np.sqrt(k * k * cin)
    scale = (rng.uniform(1.0, 3.0, cout) / spread).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    out_scale = rng.uniform(20.0, 40.0, cout).astype(np.float32)
    return x, wq, scale, bias, out_scale


# (B, H, W, Cin, Cout, k): aligned and ragged tiles (W=33, H not a multiple
# of the 8-row tile), channel tails on the CUDA-core variant (Cin 3, 5, 6),
# every channel block of both variants (Cout 1, 4, 5, 16, 32, 64 and 130),
# Cin that is 16 but not 32 channels past a k32 step (48, 72, 80), weights
# resident with the input in 64-channel chunks (144, 192), weights streamed
# in chunks (256 and 512 at 3x3, 768 at 1x1), a map that is no multiple of
# the 8x16 tile in either direction, and B = 1 at a model's map
QCONV_SHAPES = [
    (2, 16, 32, 16, 16, 3), (1, 12, 33, 5, 4, 3), (2, 9, 17, 3, 64, 3),
    (1, 8, 24, 72, 130, 3), (2, 16, 33, 40, 32, 1), (1, 13, 20, 128, 1, 1),
    (1, 7, 9, 192, 64, 1),
    (2, 9, 17, 6, 64, 3), (1, 13, 33, 512, 5, 1), (1, 13, 33, 64, 6, 3),
    (2, 27, 45, 48, 16, 3), (1, 17, 19, 144, 40, 3), (1, 7, 9, 80, 130, 3),
    (1, 13, 33, 768, 512, 1), (1, 11, 19, 256, 256, 3),
    (1, 9, 17, 512, 512, 3), (1, 120, 160, 64, 64, 3), (1, 5, 7, 16, 8, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", QCONV_SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["int8", "f32", "int32"])
def test_qconv_kernel_matches_plain_version(cuda, shape, mode):
    x, wq, scale, bias, osc = (torch.from_numpy(a).to(cuda)
                               for a in qconv_case(sum(shape), *shape))
    kw = dict(out="int32") if mode == "int32" else {}
    osc = osc if mode == "int8" else None
    kqconv.reset_launches()
    got = kqconv.qconv_int8(x, wq, scale, bias, osc, relu=mode != "f32", **kw)
    torch.cuda.synchronize()
    variant = kqconv.kernel_variant(*shape[3:])
    assert kqconv.launches == 1
    assert kqconv.variant_launches == {variant: 1}
    assert kqconv.last_plan["variant"] == variant
    assert variant.startswith("mma" if shape[3] % 16 == 0 else "dp4a")
    want = kqconv.qconv_reference(x, wq, scale, bias, osc,
                                  relu=mode != "f32", **kw)
    assert got.dtype == want.dtype == {"int8": torch.int8, "f32": torch.float32,
                                       "int32": torch.int32}[mode]
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_qconv_kernel_plans(cuda):
    """What the C side reports of its plan: weights resident at the narrow
    models' widths and streamed in chunks at the paper's, a ring of at
    least two stages, persistent blocks no more than there are tiles."""
    for shape, resident in [((8, 120, 160, 64, 64, 3), True),
                            ((8, 60, 80, 128, 128, 3), True),
                            ((1, 30, 40, 512, 512, 3), False),
                            ((1, 30, 40, 768, 512, 1), True)]:
        x, wq, scale, bias, osc = (torch.from_numpy(a).to(cuda)
                                   for a in qconv_case(1, *shape))
        kqconv.qconv_int8(x, wq, scale, bias, osc)
        torch.cuda.synchronize()
        plan = kqconv.last_plan
        b, h, w = shape[:3]
        assert plan["weights_resident"] is resident, shape
        assert 2 <= plan["stages"] <= 4
        assert plan["chunk_channels"] % 16 == 0
        assert 1 <= plan["grid_x"] <= b * -(-h // 8) * -(-w // 16)
        assert plan["shared_bytes"] <= 232448


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_requant_kernel_matches_plain_version(cuda, mode):
    rng = np.random.RandomState(7)
    for shape in [(2, 9, 17, 64), (1, 5, 7, 3), (3, 1)]:
        acc = torch.from_numpy(rng.randint(-2 ** 27, 2 ** 27, shape)
                               .astype(np.int32)).to(cuda)
        cout = shape[-1]
        scale = torch.from_numpy(rng.uniform(1e-8, 3e-8, cout)
                                 .astype(np.float32)).to(cuda)
        bias = torch.from_numpy(rng.uniform(-0.5, 0.5, cout)
                                .astype(np.float32)).to(cuda)
        osc = (torch.tensor(31.5, device=cuda) if mode == "int8" else None)
        for relu in (True, False):
            before = krequant.launches
            got = krequant.requant_epilogue(acc, scale, bias, osc, relu=relu)
            torch.cuda.synchronize()
            assert krequant.launches == before + 1
            want = krequant.requant_reference(acc, scale, bias, osc, relu=relu)
            assert got.dtype == want.dtype
            assert torch.equal(got, want), (shape, relu)


@pytest.mark.gpu
def test_int8_wrapper_checks(cuda):
    x = torch.zeros(1, 8, 8, 16, dtype=torch.int8, device=cuda)
    w = torch.zeros(4, 3, 3, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError):
        kqconv.qconv_int8(x.float(), w, 1.0, 0.0)
    with pytest.raises(ValueError, match="k in"):
        kqconv.qconv_int8(x, torch.zeros(4, 2, 2, 16, dtype=torch.int8,
                                         device=cuda), 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        kqconv.qconv_int8(x.transpose(1, 2), w, 1.0, 0.0)
    with pytest.raises(ValueError, match="int32"):
        krequant.requant_epilogue(torch.zeros(2, 4, device=cuda), 1.0, 0.0)


@pytest.mark.gpu
def test_qconv_alignment(cuda):
    """The tensor-core variant copies 16 bytes at a time: a view of x or w
    that starts off a 16-byte boundary is refused, its clone is taken, and
    the CUDA-core variant takes a view at any offset."""
    x, wq, scale, bias, osc = (torch.from_numpy(a).to(cuda)
                               for a in qconv_case(2, 2, 9, 17, 16, 16, 3))
    want = kqconv.qconv_reference(x, wq, scale, bias, osc)
    flat = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    for off in (4, 1):
        view = flat[off:off + x.numel()].view(x.shape).copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 == off
        with pytest.raises(ValueError, match="16-byte aligned"):
            kqconv.qconv_int8(view, wq, scale, bias, osc)
        assert torch.equal(kqconv.qconv_int8(view.clone(), wq, scale, bias,
                                             osc), want)
    wflat = torch.empty(wq.numel() + 16, dtype=torch.int8, device=cuda)
    wview = wflat[4:4 + wq.numel()].view(wq.shape).copy_(wq)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kqconv.qconv_int8(x, wview, scale, bias, osc)
    x5, w5, s5, b5, o5 = (torch.from_numpy(a).to(cuda)
                          for a in qconv_case(3, 2, 9, 17, 5, 24, 3))
    flat5 = torch.empty(x5.numel() + 16, dtype=torch.int8, device=cuda)
    view5 = flat5[1:1 + x5.numel()].view(x5.shape).copy_(x5)
    kqconv.reset_launches()
    got = kqconv.qconv_int8(view5, w5, s5, b5, o5)
    assert kqconv.variant_launches == {"dp4a_n32": 1}
    assert torch.equal(got, kqconv.qconv_reference(x5, w5, s5, b5, o5))


# (B, S, L, Hm, Wm, D, win): the MALF serve shape (5-scale pyramid of a
# 480x640 canvas, scale 1.4142 the largest map), the bench's lm4 shape (one
# scale) and a ragged one (odd map, odd window)
WINDOW_SHAPES = [(8, 5, 5, 170, 228, 64, 32), (8, 1, 4, 120, 160, 64, 32),
                 (3, 2, 3, 37, 29, 5, 17)]


def window_case(seed, b, s, num_lm, hm, wm, d, win, shared):
    """Random maps (B, S, L, Hm, Wm) float32, sel (B, D) and in-range
    origins (B, D, L), or (B, D, 1) when ``shared``, all int32 numpy."""
    rng = np.random.RandomState(seed)
    maps = rng.standard_normal((b, s, num_lm, hm, wm)).astype(np.float32)
    lo = 1 if shared else num_lm
    sel = rng.randint(0, s, (b, d)).astype(np.int32)
    y0 = rng.randint(0, hm - win + 1, (b, d, lo)).astype(np.int32)
    x0 = rng.randint(0, wm - win + 1, (b, d, lo)).astype(np.int32)
    return maps, sel, y0, x0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WINDOW_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_window_kernel_matches_plain_version(cuda, shape, dtype, shared):
    maps, sel, y0, x0 = window_case(sum(shape), *shape, shared)
    maps = torch.from_numpy(maps).to(cuda, dtype)
    sel, y0, x0 = (torch.from_numpy(a).to(cuda) for a in (sel, y0, x0))
    win = shape[-1]
    before = kwindow.launches
    got = kwindow.gather_windows(maps, sel, y0, x0, win)
    torch.cuda.synchronize()
    assert kwindow.launches == before + 1
    want = kwindow.gather_windows_reference(maps, sel, y0, x0, win)
    assert got.dtype == dtype and got.shape == want.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def window_edge_case(seed, win, shared, dtype, hm=45, wm=53):
    """Windows on all four edges of an odd-sized map at every column offset
    modulo 8 from either side, in maps that start one element into their
    storage (no row starts on a 16-byte boundary by construction). CPU
    tensors: maps, sel, y0, x0."""
    rng = np.random.RandomState(seed)
    b, s, num_lm = 2, 2, 3
    flat = torch.from_numpy(rng.standard_normal(b * s * num_lm * hm * wm + 1)
                            .astype(np.float32)).to(dtype)
    xs = list(range(8)) + [wm - win - k for k in range(8)]
    ys = [0, hm - win, 1, hm - win - 1]
    d, lo = len(xs) * len(ys), 1 if shared else num_lm
    y0 = np.repeat(ys, len(xs))[None, :, None] + np.zeros((b, d, lo), int)
    x0 = np.tile(xs, len(ys))[None, :, None] + np.zeros((b, d, lo), int)
    if not shared:
        x0 = (x0 + np.arange(lo)) % (wm - win + 1)
    sel = rng.randint(0, s, (b, d))
    return [flat] + [torch.from_numpy(a.astype(np.int32))
                     for a in (sel, y0, x0)]


def _assert_window_equal(maps, sel, y0, x0, win):
    before = kwindow.launches
    got = kwindow.gather_windows(maps, sel, y0, x0, win)
    torch.cuda.synchronize()
    assert kwindow.launches == before + 1
    rows = (win * maps.element_size()) % 16 == 0
    assert kwindow.last_path == ("rows" if rows else "elements")
    want = kwindow.gather_windows_reference(maps, sel, y0, x0, win)
    bits = torch.int16 if maps.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == maps.dtype and got.shape == want.shape
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("win", [8, 17, 32])
@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_window_kernel_edges_and_offsets(cuda, dtype, win, shared):
    flat, sel, y0, x0 = (t.to(cuda) for t in
                         window_edge_case(win, win, shared, dtype))
    maps = flat[1:].view(2, 2, 3, 45, 53)
    assert maps.is_contiguous() and maps.data_ptr() % 16 != 0
    _assert_window_equal(maps, sel, y0, x0, win)


def out_of_range_origins(seed, b, d, lo, hm, wm, win):
    """int32 origins (B, D, lo) from ``win`` before the map to ``win`` past
    its last in-range origin, and the same moved to the nearest in-range
    one."""
    rng = np.random.RandomState(seed)
    y0 = rng.randint(-win, hm + 1, (b, d, lo)).astype(np.int32)
    x0 = rng.randint(-win, wm + 1, (b, d, lo)).astype(np.int32)
    return (y0, x0), (np.clip(y0, 0, hm - win), np.clip(x0, 0, wm - win))


@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_window_reference_moves_origins_into_the_map(shared):
    """An origin outside [0, Hm - win] x [0, Wm - win] gives the window at
    the nearest origin inside: the plain version reads nothing outside its
    map, as the kernel."""
    b, s, num_lm, hm, wm, d, win = 2, 2, 3, 21, 27, 40, 8
    maps, sel, _, _ = window_case(5, b, s, num_lm, hm, wm, d, win, shared)
    outside, inside = out_of_range_origins(6, b, d, 1 if shared else num_lm,
                                           hm, wm, win)
    assert (outside[0] != inside[0]).any() and (outside[1] != inside[1]).any()
    maps, sel = torch.from_numpy(maps), torch.from_numpy(sel)
    got = kwindow.gather_windows(maps, sel, *map(torch.from_numpy, outside),
                                 win)
    want = kwindow.gather_windows_reference(
        maps, sel, *map(torch.from_numpy, inside), win)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("win", [8, 17])
@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_window_kernel_out_of_range_origins(cuda, dtype, win, shared):
    """Both kernels (16-byte rows at win 8, elements at win 17) move an
    out-of-range origin into the map as the plain version does."""
    b, s, num_lm, hm, wm, d = 2, 2, 3, 37, 45, 50
    maps, sel, _, _ = window_case(win, b, s, num_lm, hm, wm, d, win, shared)
    outside, _ = out_of_range_origins(win, b, d, 1 if shared else num_lm,
                                      hm, wm, win)
    _assert_window_equal(torch.from_numpy(maps).to(cuda, dtype),
                         *(torch.from_numpy(a).to(cuda)
                           for a in (sel, *outside)), win)


@pytest.mark.gpu
@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(b=st.integers(1, 4), s=st.integers(1, 3), num_lm=st.integers(1, 6),
       hm=st.integers(8, 70), half_wm=st.integers(4, 40),
       d=st.integers(1, 40), win=st.integers(1, 40), shared=st.booleans(),
       bf16=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_window_kernel_random_shapes(cuda, b, s, num_lm, hm, half_wm, d, win,
                                     shared, bf16, seed):
    wm = 2 * half_wm + 1                       # odd map widths
    win = min(win, hm, wm)
    maps, sel, y0, x0 = window_case(seed, b, s, num_lm, hm, wm, d, win, shared)
    maps = torch.from_numpy(maps).to(cuda, torch.bfloat16 if bf16
                                     else torch.float32)
    _assert_window_equal(maps, *(torch.from_numpy(a).to(cuda)
                                 for a in (sel, y0, x0)), win)


@pytest.mark.gpu
def test_window_wrapper_checks(cuda):
    maps = torch.zeros(2, 1, 3, 20, 24, device=cuda)
    sel = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    org = torch.zeros(2, 4, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kwindow.gather_windows(maps.half(), sel, org, org, 8)
    with pytest.raises(TypeError):
        kwindow.gather_windows(maps, sel.long(), org, org, 8)
    with pytest.raises(ValueError, match="origins"):
        kwindow.gather_windows(maps, sel, org[..., :2], org[..., :2], 8)
    with pytest.raises(ValueError, match="win"):
        kwindow.gather_windows(maps, sel, org, org, 21)
    with pytest.raises(ValueError, match="devices"):
        kwindow.gather_windows(maps, sel.cpu(), org, org, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kwindow.gather_windows(maps.transpose(3, 4), sel, org, org, 8)


def test_window_wrapper_refuses_other_devices():
    maps = torch.zeros(1, 1, 2, 8, 8, device="meta")
    sel = torch.zeros(1, 3, dtype=torch.int32, device="meta")
    org = torch.zeros(1, 3, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kwindow.gather_windows(maps, sel, org, org, 4)


def covering_vector(storage, addr):
    """The 16 bytes of ``storage`` (uint8, its length a multiple of 16) at
    byte ``addr``, as ``csrc/window.cu`` gets them: the aligned 16-byte word
    that holds the first byte and, only if ``addr`` is off a boundary, the
    next one; the two joined by a whole-word select and a funnel shift."""
    shift = addr & 15
    words = storage[addr - shift:addr - shift + 16].view(np.uint32)
    nxt = (storage[addr - shift + 16:addr - shift + 32].view(np.uint32)
           if shift else np.zeros(4, np.uint32))
    w = np.concatenate([words, nxt]).astype(np.uint64)
    skip, bits = shift >> 2, np.uint64((shift & 3) * 8)
    t = w[skip:skip + 5]
    out = ((t[1:] << np.uint64(32) | t[:-1]) >> bits) & np.uint64(0xffffffff)
    return out.astype(np.uint32).view(np.uint8)


def gather_rows_model(maps, sel, y0, x0, win, base_offset):
    """``gather_windows`` as the row kernel computes it, on the bytes of
    ``maps`` (a torch tensor) laid out ``base_offset`` bytes into 16-byte
    aligned storage. Rows whose bytes are no multiple of 16 move element by
    element, as in the kernel. Returns the output's bytes."""
    esz = maps.element_size()
    raw = maps.contiguous().view(torch.uint8).numpy().reshape(-1)
    storage = np.zeros(-(-(base_offset + raw.size) // 16) * 16, np.uint8)
    storage[base_offset:base_offset + raw.size] = raw
    b, s, num_lm, hm, wm = maps.shape
    d, lo = sel.shape[1], y0.shape[2]
    row_bytes = win * esz
    out = np.zeros((b, d, num_lm, win, row_bytes), np.uint8)
    for bi in range(b):
        for di in range(d):
            for l in range(num_lm):
                oy = int(y0[bi, di, l if lo > 1 else 0])
                ox = int(x0[bi, di, l if lo > 1 else 0])
                plane = ((bi * s + int(sel[bi, di])) * num_lm + l) * hm
                for r in range(win):
                    src = base_offset + ((plane + oy + r) * wm + ox) * esz
                    if row_bytes % 16:
                        out[bi, di, l, r] = storage[src:src + row_bytes]
                        continue
                    for k in range(row_bytes // 16):
                        out[bi, di, l, r, 16 * k:16 * k + 16] = \
                            covering_vector(storage, src + 16 * k)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("win", [8, 17, 32])
@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_realigned_row_copy_equals_plain_version(dtype, win, shared):
    """What the row kernel relies on: aligned covering words, shifted
    together, give the plain version's window bit for bit, for every column
    offset modulo 8 (bf16) and 4 (f32) from either edge, windows on all four
    edges of an odd-sized map, and a map that starts off a 16-byte boundary;
    34- and 68-byte rows (win 17) take the element copy."""
    rng = np.random.RandomState(win)
    b, s, num_lm, hm, wm = 1, 2, 2, 37, 45
    maps = torch.from_numpy(rng.standard_normal((b, s, num_lm, hm, wm))
                            .astype(np.float32)).to(dtype)
    xs = list(range(8)) + [wm - win - k for k in range(8)]
    ys = [0, hm - win, 1, hm - win - 1]
    d, lo = len(xs) * len(ys), 1 if shared else num_lm
    y0 = np.repeat(ys, len(xs))[None, :, None] + np.zeros((b, d, lo), int)
    x0 = np.tile(xs, len(ys))[None, :, None] + np.zeros((b, d, lo), int)
    if not shared:
        x0 = (x0 + 3 * np.arange(lo)) % (wm - win + 1)
    sel = rng.randint(0, s, (b, d))
    idx = [torch.from_numpy(a.astype(np.int32)) for a in (sel, y0, x0)]
    want = kwindow.gather_windows_reference(maps, *idx, win)
    want = want.contiguous().view(torch.uint8).numpy().reshape(
        b, d, num_lm, win, -1)
    for base_offset in (0, maps.element_size()):
        got = gather_rows_model(maps, sel, y0, x0, win, base_offset)
        np.testing.assert_array_equal(got, want)


def label_rows(seed, b, k, m, num_lm):
    """Packed rasterizer rows as numpy float32: box rows (B, K, 8) =
    [cx, cy, rc2, rg2, x1, y1, x2, y2] and landmark rows (B, K*L, 3) =
    [lx, ly, r2]. Half the centres are integers with integer radii, so that
    pixels lie exactly on a disc's rim (d2 == rc2); a quarter of the slots
    are never positive (rc2 = -1), an eighth never gray either; patch 0 is
    empty; where K >= 2, patch 1 holds two boxes with one centre and (K >= 4)
    two whose centres are equidistant from a column of pixels."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, m, (b, k, 2))
    r = rng.uniform(0.5, m / 4, (b, k))
    integer = rng.rand(b, k) < 0.5
    c = np.where(integer[..., None], np.round(c), c)
    r = np.where(integer, np.maximum(np.round(r), 1), r)
    kind = rng.rand(b, k)
    rc2 = np.where(kind < 0.25, -1.0, r * r)
    rg2 = np.where(kind < 0.125, -1.0, (r + 2) ** 2)
    half = rng.uniform(1, m / 3, (b, k, 2))
    rows = np.stack([c[..., 0], c[..., 1], rc2, rg2,
                     c[..., 0] - half[..., 0], c[..., 1] - half[..., 1],
                     c[..., 0] + half[..., 0], c[..., 1] + half[..., 1]], -1)
    rows[0, :, 2:4] = -1.0
    if b > 1 and k >= 2:
        rows[1, 0, :4] = [m // 2, m // 2, 9.0, 25.0]
        rows[1, 1, :4] = rows[1, 0, :4]
    if b > 1 and k >= 4:
        rows[1, 2, :4] = [2.0, 3.0, 16.0, 36.0]
        rows[1, 3, :4] = [6.0, 3.0, 16.0, 36.0]
    lm = np.concatenate([rng.uniform(-2, m + 2, (b, k * num_lm, 2)),
                         np.where(rng.rand(b, k * num_lm, 1) < 0.3, -1.0, 1.0)],
                        -1)
    lm[:, ::2, :2] = np.round(lm[:, ::2, :2])      # rim-exact: d2 == 1
    return rows.astype(np.float32), lm.astype(np.float32)


# (B, K, M, L): the training shape, a ragged one and a single pixel row
LABEL_SHAPES = [(32, 16, 60, 5), (3, 1, 8, 1), (2, 5, 17, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LABEL_SHAPES, ids=str)
def test_rasterizer_kernels_match_plain_versions(cuda, shape):
    b, k, m, num_lm = shape
    rows, lm_rows = (torch.from_numpy(a).to(cuda)
                     for a in label_rows(sum(shape), *shape))
    before = dict(klabels.launches)
    got = klabels.rasterize_boxes(rows, m, 0.08)
    got_lm = klabels.rasterize_landmarks(lm_rows, m, num_lm)
    torch.cuda.synchronize()
    assert klabels.launches == {k_: v + 1 for k_, v in before.items()}
    want = klabels.rasterize_boxes_reference(rows, m, float(np.float32(0.08)))
    want_lm = klabels.rasterize_landmarks_reference(lm_rows, m, num_lm)
    assert got[0].sum() > 0 or b * k < 4
    for g, w in zip(got + (got_lm,), want + (want_lm,)):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.gpu
def test_rasterizer_wrapper_checks(cuda):
    rows = torch.zeros(2, 4, 8, device=cuda)
    with pytest.raises(TypeError):
        klabels.rasterize_boxes(rows.double(), 8, 0.08)
    with pytest.raises(ValueError, match="rows"):
        klabels.rasterize_boxes(rows[..., :7].contiguous(), 8, 0.08)
    with pytest.raises(ValueError, match="contiguous"):
        klabels.rasterize_boxes(torch.zeros(2, 8, 4, device=cuda)
                                .transpose(1, 2), 8, 0.08)
    with pytest.raises(ValueError, match="rows per patch"):
        klabels.rasterize_boxes(torch.zeros(1, 1025, 8, device=cuda), 8, 0.08)
    with pytest.raises(ValueError, match="K\\*L"):
        klabels.rasterize_landmarks(torch.zeros(2, 7, 3, device=cuda), 8, 2)


def test_rasterizer_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        klabels.rasterize_boxes(torch.zeros(1, 2, 8, device="meta"), 8, 0.08)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        klabels.rasterize_landmarks(torch.zeros(1, 2, 3, device="meta"), 8, 1)


def ohem_case(seed, b, p, kind):
    """(sq, pos, ign, rnd) numpy inputs of ``ohem_select``: 'random' errors
    with positives and a gray zone; 'tied' (every error 0.25, so the noise
    alone orders the hard half); 'no_pos' (min_neg applies); 'short' (fewer
    candidates than the quota); 'levels' (errors on 5 levels: large tie
    classes at the cutoff)."""
    rng = np.random.RandomState(seed)
    sq = rng.uniform(0, 2, (b, p)).astype(np.float32) ** 2
    pos = rng.rand(b, p) < 0.03
    ign = (rng.rand(b, p) < 0.05) & ~pos
    if kind == "tied":
        sq[:] = 0.25
    elif kind == "no_pos":
        pos[:] = False
    elif kind == "short":
        pos = rng.rand(b, p) < 0.6
        ign = ~pos & (rng.rand(b, p) < 0.9)
    elif kind == "levels":
        sq = (rng.randint(0, 5, (b, p)) / 4).astype(np.float32)
    return sq, pos, ign, rng.rand(b, p).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "tied", "no_pos", "short",
                                  "levels"])
@pytest.mark.parametrize("bp", [(32, 3600), (3, 256), (2, 513), (1, 16384),
                                (2, 37)], ids=str)
def test_ohem_kernel_matches_plain_version(cuda, kind, bp):
    args = [torch.from_numpy(a).to(cuda)
            for a in ohem_case(sum(bp), *bp, kind)]
    before = kohem.launches
    got = kohem.ohem_select(*args, 1.0, 0.5, 16)
    torch.cuda.synchronize()
    assert kohem.launches == before + 1
    want = kohem.ohem_select_reference(*args, 1.0, 0.5, 16)
    assert got.dtype == torch.bool and torch.equal(got, want)
    got = kohem.ohem_select(*args, 2.5, 0.3, 7)
    assert torch.equal(got, kohem.ohem_select_reference(
        *args, float(np.float32(2.5)), float(np.float32(0.3)), 7))


def ohem_edge_case(seed, p, min_neg):
    """One sample per row, no positives (the quota is ``min_neg``, half of
    it hard), with a candidate set that is empty, one pixel, as large as
    either quota and one more, around the 32 and 256 elements the kernel's
    warp re-gathers at, and the whole sample; the second half of the rows
    with errors on a grid of halves (ties at every cutoff)."""
    rng = np.random.RandomState(seed)
    half = min_neg // 2
    sizes = sorted({0, 1, half, half + 1, min_neg, min_neg + 1, 31, 32, 33,
                    255, 256, 257, 300, p - 1, p} & set(range(p + 1)))
    b = 2 * len(sizes)
    sq = rng.uniform(0, 2, (b, p)).astype(np.float32) ** 2
    sq[len(sizes):] = np.round(sq[len(sizes):] * 2) / 2
    ign = np.ones((b, p), bool)
    for i, n in enumerate(sizes * 2):
        ign[i, rng.permutation(p)[:n]] = False
    return sq, np.zeros((b, p), bool), ign, rng.rand(b, p).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("min_neg", [0, 1, 16])
@pytest.mark.parametrize("p", [300, 3600])
def test_ohem_kernel_edge_sets(cuda, p, min_neg):
    args = [torch.from_numpy(a).to(cuda)
            for a in ohem_edge_case(p + min_neg, p, min_neg)]
    got = kohem.ohem_select(*args, 1.0, 0.5, min_neg)
    torch.cuda.synchronize()
    want = kohem.ohem_select_reference(*args, 1.0, 0.5, min_neg)
    assert torch.equal(got, want)
    assert int(got.sum(1).max()) == min(min_neg, p)


@pytest.mark.gpu
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(b=st.integers(1, 64), p=st.integers(1, 16384),
       kind=st.sampled_from(["random", "tied", "no_pos", "short", "levels"]),
       ratio=st.sampled_from([1.0, 2.5, 0.3]),
       hard_frac=st.sampled_from([0.5, 0.3, 1.0, 0.0]),
       min_neg=st.integers(0, 40), seed=st.integers(0, 2 ** 16))
def test_ohem_kernel_random_shapes(cuda, b, p, kind, ratio, hard_frac,
                                   min_neg, seed):
    b = min(b, max(1, 2 ** 18 // p))           # keeps the plain version short
    args = [torch.from_numpy(a).to(cuda) for a in ohem_case(seed, b, p, kind)]
    got = kohem.ohem_select(*args, ratio, hard_frac, min_neg)
    torch.cuda.synchronize()
    want = kohem.ohem_select_reference(
        *args, float(np.float32(ratio)), float(np.float32(hard_frac)), min_neg)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_ohem_wrapper_checks(cuda):
    sq = torch.zeros(2, 64, device=cuda)
    flag = torch.zeros(2, 64, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        kohem.ohem_select(sq.double(), flag, flag, sq, 1.0, 0.5, 16)
    with pytest.raises(TypeError):
        kohem.ohem_select(sq, flag.int(), flag, sq, 1.0, 0.5, 16)
    with pytest.raises(ValueError, match="four"):
        kohem.ohem_select(sq, flag[:, :32], flag, sq, 1.0, 0.5, 16)
    with pytest.raises(ValueError, match="16384"):
        big = torch.zeros(1, 16385, device=cuda)
        kohem.ohem_select(big, big > 0, big > 0, big, 1.0, 0.5, 16)
    with pytest.raises(ValueError, match="devices"):
        kohem.ohem_select(sq, flag.cpu(), flag, sq, 1.0, 0.5, 16)
    with pytest.raises(ValueError, match="contiguous"):
        kohem.ohem_select(sq.t().contiguous().t(), flag, flag, sq, 1.0, 0.5,
                          16)


def test_ohem_wrapper_refuses_other_devices():
    sq = torch.zeros(1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        kohem.ohem_select(sq, sq > 0, sq > 0, sq, 1.0, 0.5, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["kitti_vehicle", "malf_face"])
def test_train_step_repeats_on_the_card(cuda, preset):
    """A whole train step on the card (rasterizer and OHEM kernels, cuDNN
    forward and backward, the SGD update), taken twice from the same
    parameters, momentum and generator state: the same parameters, momentum,
    loss and update norm bit for bit. malf_face goes through the canvas
    step (patches sampled on the card, landmarks, refine, two OHEM terms)."""
    import densebox_tpu_torch as port
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.train import (create_train_state,
                                          make_canvas_train_step,
                                          make_train_step)

    cfg = getattr(port, preset)()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, width_mult=0.25),
        train=dataclasses.replace(cfg.train, batch_size=8))
    canvas = preset == "malf_face"
    label = (dataclasses.replace(cfg.label, patch_size=480) if canvas
             else cfg.label)
    model = port.DenseBox(cfg.model, device=cuda)
    state = create_train_state(model, cfg, device=cuda)
    step = (make_canvas_train_step if canvas else make_train_step)(
        model, cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = synthetic_batch(gen, 8, label, cfg.train.max_boxes,
                            cfg.model.num_landmarks, device=cuda)
    step(state, batch)                          # a state with momentum
    start = ({k: v.clone() for k, v in model.state_dict().items()},
             {k: v.clone() for k, v in state.momentum.items()},
             state.generator.get_state())
    before = (klabels.launches["rasterize_boxes"], kohem.launches)
    runs = []
    for _ in range(2):
        state.load(start[0], start[1], 1)
        state.generator.set_state(start[2])
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in model.state_dict().items()},
                     {k: v.clone() for k, v in state.momentum.items()},
                     {k: v.clone() for k, v in metrics.items()}))
    assert klabels.launches["rasterize_boxes"] == before[0] + 2
    assert kohem.launches == before[1] + (4 if canvas else 2)
    for first, second in zip(runs[0], runs[1]):
        assert first.keys() == second.keys()
        for k in first:
            assert torch.equal(first[k], second[k]), k
    assert all(bool(torch.isfinite(v)) for v in runs[0][2].values())
    assert any(not torch.equal(v, start[0][k]) for k, v in runs[0][0].items())
