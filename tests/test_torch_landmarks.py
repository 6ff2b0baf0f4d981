"""The port's landmark and refine detect path against the JAX package, on
the CPU.

Bars:
* window gather: the plain version equals ``gather_windows_jax`` and the
  Pallas kernel (interpret mode) bit for bit, f32 and bf16, shared and
  per-landmark origins;
* ``decode_landmarks`` and ``decode_landmarks_selected`` on the same maps
  and boxes: ``lm_valid`` identical, points within 1e-4 px of JAX's run
  eagerly (jitted, XLA's CPU backend may contract ``a*a + b*b`` and
  ``lo - 2c + hi`` into fused multiply-adds; the port rounds every
  operation on its own, as JAX does eagerly);
* end to end (``detect_batch`` with landmarks and refine, f32 maps, against
  JAX's ``detect_batch`` run eagerly around a jitted forward): the bars of
  test_torch_detect.py for boxes and scores, ``lm_valid`` identical and
  points within 1e-3 px. The two forwards differ by summation order
  (~1e-6), which could flip an argmax between two window pixels closer than
  that; so each case first checks that the port's decode does not move
  when its maps move by 1e-5 (a property of the seed, not of the port);
* int8 (``QuantDenseBox`` with JAX's qparams) against JAX's fused chain run
  eagerly with its kernels' jnp twins: identical.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu.infer import detector as jax_detector
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import quant as jax_quant
from densebox_tpu.ops.pallas.window import gather_windows_pallas
from densebox_tpu.ops.window import gather_windows_jax
from densebox_tpu_torch.infer import (decode_landmarks,
                                      decode_landmarks_selected,
                                      detect_batch, detect_from_maps,
                                      lm_scale_select, pyramid_maps,
                                      pyramid_shapes, resolved_lm_dtype)
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox, from_flax,
                                       quantize_densebox)
from densebox_tpu_torch.ops.window import (gather_windows,
                                           gather_windows_reference)
from densebox_tpu_torch.serve import DetectServer
from test_torch_detect import _assert_detections_match
from test_torch_quant import jax_twins

STRIDE = 4
ANCHORS4 = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- window gather ---------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shared", [False, True], ids=["per_lm", "shared"])
def test_gather_windows_reference_matches_jax(dtype, shared):
    rng = np.random.RandomState(0 if shared else 1)
    b, s, num_lm, hm, wm, d, win = 2, 3, 4, 40, 37, 7, 16
    maps = rng.rand(b, s, num_lm, hm, wm).astype(np.float32)
    sel = rng.randint(0, s, (b, d)).astype(np.int32)
    lo = 1 if shared else num_lm
    y0 = rng.randint(0, hm - win + 1, (b, d, lo)).astype(np.int32)
    x0 = rng.randint(0, wm - win + 1, (b, d, lo)).astype(np.int32)
    jargs = (jnp.asarray(maps, dtype), jnp.asarray(sel), jnp.asarray(y0),
             jnp.asarray(x0))
    tmaps = torch.from_numpy(maps).to(DTYPES[dtype])
    got = gather_windows(tmaps, *map(torch.from_numpy, (sel, y0, x0)), win)
    assert got.dtype == DTYPES[dtype] and got.shape == (b, d, num_lm, win, win)
    for want in (gather_windows_jax(*jargs, win),
                 gather_windows_pallas(*jargs, win)):
        # bitwise: compare the raw 16- or 32-bit words
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))


def test_gather_windows_reference_ragged():
    """An odd window in an odd map, windows touching every edge."""
    rng = np.random.RandomState(2)
    maps = torch.from_numpy(rng.rand(1, 2, 3, 21, 19).astype(np.float32))
    sel = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    y0 = torch.tensor([[[0], [4], [2]]], dtype=torch.int32)
    x0 = torch.tensor([[[2], [0], [1]]], dtype=torch.int32)
    got = gather_windows_reference(maps, sel, y0, x0, 17)
    for d in range(3):
        s, y, x = int(sel[0, d]), int(y0[0, d, 0]), int(x0[0, d, 0])
        assert torch.equal(got[0, d], maps[0, s, :, y:y + 17, x:x + 17])


# -- decode ------------------------------------------------------------------


def _random_case(seed, b=2, d=8, s=2, num_lm=4):
    """tests/test_lm_window.py's random case (two scales here), plus three
    edge boxes in image 0: a degenerate box between pixel centres, an
    oversized box, and a box beyond every map (no allowed pixel in its
    window)."""
    rng = np.random.RandomState(seed)
    shapes = [(24 + 4 * i, 20 + 6 * i) for i in range(s)]
    scales = [(0.6 + 0.4 * i, 0.5 + 0.5 * i) for i in range(s)]
    maps = [(rng.rand(b, h, w, num_lm).astype(np.float32), sc)
            for (h, w), sc in zip(shapes, scales)]
    cx = rng.uniform(20, 80, (b, d))
    cy = rng.uniform(20, 80, (b, d))
    half = rng.uniform(4, 20, (b, d))
    boxes = np.stack([cx - half, cy - half, cx + half, cy + half], -1)
    boxes[0, :3] = [[41.0, 41.0, 41.9, 41.9], [2.0, 2.0, 158.0, 158.0],
                    [400.0, 400.0, 420.0, 420.0]]
    valid = rng.rand(b, d) > 0.2
    valid[0, :3] = True
    sel = rng.randint(0, s, (b, d)).astype(np.int32)
    return maps, boxes.astype(np.float32), valid, sel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("anchored", [True, False],
                         ids=["anchored", "anchorless"])
def test_decode_landmarks_selected_matches_jax_eager(dtype, anchored):
    anchors = np.asarray(ANCHORS4, np.float32) if anchored else None
    for seed in range(2):
        maps, boxes, valid, sel = _random_case(seed)
        want, want_ok = jax_detector.decode_landmarks_selected(
            [(jnp.asarray(m, dtype), sc) for m, sc in maps], jnp.asarray(sel),
            jnp.asarray(boxes), jnp.asarray(valid), stride=STRIDE, window=16,
            anchors=None if anchors is None else jnp.asarray(anchors),
            backend="jax")
        got, got_ok = decode_landmarks_selected(
            [(torch.from_numpy(m).to(DTYPES[dtype]), sc) for m, sc in maps],
            torch.from_numpy(sel), torch.from_numpy(boxes),
            torch.from_numpy(valid), stride=STRIDE, window=16,
            anchors=anchors)
        assert got.dtype == torch.float32 and got_ok.dtype == torch.bool
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        ok = got_ok.numpy()
        # the degenerate box and the box beyond the maps (its window has no
        # allowed pixel: an all -inf row, argmax 0 in both frameworks) fall
        # back to their centres, and so does the oversized box without
        # anchors
        assert ok.any() and not ok[0, [0, 2]].any()
        assert anchored or not ok[0, 1].any()
        np.testing.assert_allclose(got.numpy()[0, 2, :, 0], 410.0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("anchored", [True, False],
                         ids=["anchored", "anchorless"])
def test_decode_landmarks_matches_jax_eager(dtype, anchored):
    """The single-image decode of image 0 (with the edge boxes), at every
    scale."""
    anchors = np.asarray(ANCHORS4, np.float32) if anchored else None
    maps, boxes, valid, _ = _random_case(3)
    for m, (sx, sy) in maps:
        for i in range(1):
            kw = dict(stride=STRIDE, scale_x=sx, scale_y=sy, window=16)
            want = jax_detector.decode_landmarks(
                jnp.asarray(m[i], dtype), jnp.asarray(boxes[i]),
                jnp.asarray(valid[i]),
                anchors=None if anchors is None else jnp.asarray(anchors),
                **kw)
            got = decode_landmarks(
                torch.from_numpy(m[i]).to(DTYPES[dtype]),
                torch.from_numpy(boxes[i]), torch.from_numpy(valid[i]),
                anchors=anchors, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=0)


def test_std_scale_select_matches_jax():
    """The 'std' selection (argmin of |log| mismatches) on random boxes at
    the MALF preset's pyramid: the same scale for every box (XLA's and
    torch's log may differ in the last bit, which could flip a box whose
    two mismatches tie within that)."""
    rng = np.random.RandomState(0)
    y1 = rng.uniform(0, 400, (4, 4096)).astype(np.float32)
    hgt = np.exp(rng.uniform(np.log(4), np.log(480), (4, 4096)))
    boxes = np.zeros((4, 4096, 4), np.float32)
    boxes[..., 1] = y1
    boxes[..., 3] = y1 + hgt.astype(np.float32)
    shapes = pyramid_shapes(480, 640, (0.3536, 0.5, 0.7071, 1.0, 1.4142))
    xy = [(sx, sy) for _, _, sy, sx in shapes]
    heights = jnp.maximum(jnp.asarray(boxes)[..., 3]
                          - jnp.asarray(boxes)[..., 1], 1e-6)
    want = jnp.argmin(jnp.stack([jnp.abs(jnp.log(heights * sy / 50.0))
                                 for _, sy in xy], axis=-1), axis=-1)
    got = lm_scale_select(torch.from_numpy(boxes), None, xy,
                          InferCfg(lm_decode="std"),
                          LabelCfg(std_height_px=50.0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) == len(xy)


def test_resolved_lm_dtype_matches_jax():
    for ld in ("auto", "float32", "bfloat16"):
        cfg = InferCfg(lm_dtype=ld)
        assert resolved_lm_dtype(cfg) == jax_detector.resolved_lm_dtype(cfg)
    assert resolved_lm_dtype(InferCfg()) == "bfloat16"


# -- end to end ------------------------------------------------------------

LM_CFG = ModelCfg(width_mult=0.125, num_landmarks=4, use_refine=True)
PYRAMID = (0.7071, 1.0)
LABELS = {"anchored": LabelCfg(patch_size=64, std_height_px=20.0,
                               lm_anchors=ANCHORS4),
          "anchorless": LabelCfg(patch_size=64, std_height_px=20.0)}
IMG = np.random.RandomState(3).rand(2, 96, 128, 3).astype(np.float32)


def _with_box_sized_loc(params):
    """Random weights put the loc map near 0, i.e. boxes of a pixel or so,
    all of which decode to the centre fallback. A loc bias of 1 (times
    loc_norm) gives boxes of a few map pixels on every side."""
    params = jax.tree.map(np.asarray, params)
    loc = params["params"]["loc"]["loc_conv2"]
    loc["bias"] = loc["bias"] + np.float32(1.0)
    return params


@pytest.fixture(scope="module")
def lm_models():
    """(the port on the JAX init's weights, the base InferCfg with a live
    threshold, jax_detect(infer, label, images=IMG): JAX's detect_batch run
    eagerly around a jitted forward, each result computed once)."""
    jmodel = JaxDenseBox(LM_CFG)
    params = _with_box_sized_loc(jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, 96, 128, 3))))
    port = DenseBox(LM_CFG, device="cpu")
    port.load_state_dict(from_flax(params, LM_CFG))
    with torch.inference_mode():
        refined = port.eval()(torch.from_numpy(IMG))["refined"]
    # the window gather's Pallas interpret kernel costs seconds of lowering
    # per call; its windows equal the jax backend's bit for bit (above)
    infer = InferCfg(scales=PYRAMID, topk_per_scale=64, pre_nms_topk=96,
                     max_dets=16, lm_dtype="float32", nms_backend="jax",
                     lm_backend="jax",
                     score_thresh=float(np.quantile(refined.numpy(), 0.9)))
    forward = SimpleNamespace(apply=jax.jit(jmodel.apply))
    cache = {}

    def jax_detect(infer, label, images=IMG):
        key = (infer, label, images.tobytes())
        if key not in cache:
            out = jax_detector.detect_batch(forward, params,
                                            jnp.asarray(images), infer, label)
            cache[key] = {k: np.asarray(v) for k, v in out.items()}
        return cache[key]

    return port, infer, jax_detect


def _port_detect(port, infer, label):
    with torch.inference_mode():
        levels = pyramid_maps(port, torch.from_numpy(IMG), infer)
        out = detect_from_maps(levels, IMG.shape[1:3], infer, label)
    return levels, {k: v.numpy() for k, v in out.items()}


def _assert_seed_has_no_argmax_flips(levels, got, infer, label):
    """Heatmaps moved by up to 1e-5 (ten times the frameworks' difference)
    move no landmark by more than the sub-pixel parabola's own response
    (< 0.05 px): no argmax lands on another pixel."""
    gen = torch.Generator().manual_seed(0)
    moved = [({k: (v + (torch.rand(v.shape, generator=gen) - 0.5) * 2e-5
                   if k == "lm" else v) for k, v in out.items()}, xy)
             for out, xy in levels]
    with torch.inference_mode():
        shaken = detect_from_maps(moved, IMG.shape[1:3], infer, label)
    np.testing.assert_array_equal(shaken["lm_valid"].numpy(), got["lm_valid"])
    assert np.abs(shaken["lm_points"].numpy() - got["lm_points"]).max() \
        < 0.05, "seed has landmark argmax near-ties"


def _assert_landmarks_match(got, want):
    _assert_detections_match(got, want)
    np.testing.assert_array_equal(got["lm_valid"], want["lm_valid"])
    np.testing.assert_allclose(got["lm_points"], want["lm_points"],
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("label,lm_decode", [
    ("anchored", "std"), ("anchored", "source"), ("anchored", "finest"),
    ("anchorless", "std")])
def test_detect_batch_matches_jax(lm_models, label, lm_decode):
    port, infer, jax_detect = lm_models
    infer = dataclasses.replace(infer, lm_decode=lm_decode)
    label = LABELS[label]
    want = jax_detect(infer, label)
    levels, got = _port_detect(port, infer, label)
    _assert_seed_has_no_argmax_flips(levels, got, infer, label)
    assert set(got) == set(want)
    assert got["lm_points"].shape == (2, 16, 4, 2)
    assert want["valid"].sum() > 10 and want["lm_valid"].sum() > 20
    _assert_landmarks_match(got, want)


@pytest.mark.parametrize("label", list(LABELS))
def test_lm_topk_truncation_matches_jax(lm_models, label):
    """lm_topk decodes the top slots as the full decode does and zero-pads
    the rest: the port's truncated run against JAX's full one (JAX's own
    tests hold its truncated run to its full one the same way)."""
    port, infer, jax_detect = lm_models
    want = dict(jax_detect(infer, LABELS[label]))
    _, got = _port_detect(port, dataclasses.replace(infer, lm_topk=5),
                          LABELS[label])
    assert want["lm_valid"][:, :5].any() and want["lm_valid"][:, 5:].any()
    want["lm_valid"] = np.where(np.arange(16)[:, None] < 5,
                                want["lm_valid"], False)
    want["lm_points"] = np.where(np.arange(16)[:, None, None] < 5,
                                 want["lm_points"], 0.0)
    _assert_landmarks_match(got, want)


def test_candidates_decode_refined_score(lm_models):
    """Candidates come from the refine branch's map when the model has one
    (as JAX's ``out.get("refined", out["score"])``); here the two maps
    pick different detections, so decoding ``score`` would not match."""
    port, infer, jax_detect = lm_models
    label = LABELS["anchored"]
    want = jax_detect(infer, label)
    levels, got = _port_detect(port, infer, label)
    _assert_detections_match(got, want)
    with torch.inference_mode():
        unrefined = detect_from_maps(
            [({k: v for k, v in out.items() if k != "refined"}, xy)
             for out, xy in levels], IMG.shape[1:3], infer, label)
    assert not np.allclose(unrefined["scores"].numpy(), want["scores"],
                           atol=1e-2)


def test_anchor_count_mismatch_raises(lm_models):
    port, infer, _ = lm_models
    label = LabelCfg(patch_size=64, std_height_px=20.0,
                     lm_anchors=ANCHORS4[:3])
    with pytest.raises(ValueError, match="lm_anchors has 3 points"):
        detect_batch(port, torch.from_numpy(IMG), infer, label)


def test_server_returns_landmarks_matching_jax(lm_models):
    """A request smaller than the canvas comes back with JAX's landmarks of
    the letterboxed canvas, in the image's own coordinates."""
    port, infer, jax_detect = lm_models
    label = LABELS["anchored"]
    canvas = IMG.copy()          # B=2 as the other runs: no new compiles
    canvas[0, 80:] = 0.0
    canvas[0, :, 112:] = 0.0
    want = jax_detect(infer, label, canvas)
    server = DetectServer(port, infer, label, canvas_hw=(96, 128),
                          max_batch=2, batch_window_ms=1.0, device="cpu")
    try:
        dets = server.submit(IMG[0, :80, :112])
    finally:
        server.close()
    v = want["valid"][0]
    assert v.sum() > 5 and dets["lm_points"].shape == (v.sum(), 4, 2)
    assert want["lm_valid"][0][v].any()
    np.testing.assert_array_equal(dets["lm_valid"], want["lm_valid"][0][v])
    np.testing.assert_allclose(dets["lm_points"], want["lm_points"][0][v],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(dets["boxes"], want["boxes"][0][v],
                               atol=1e-3, rtol=0)


# -- int8 ------------------------------------------------------------------

Q_CFG = ModelCfg(stem="s2d4", trunk_depth=2, width_mult=0.125,
                 num_landmarks=4, use_refine=True, compute_dtype="bfloat16")


class _TwinForward:
    """JAX's fused int8 chain with its kernels' jnp twins, run eagerly (the
    rest of detect_batch then runs eagerly too, without disable_jit)."""

    def __init__(self, cfg):
        self.model = jax_quant.QuantDenseBox(cfg, backend="pallas")

    def apply(self, qparams, x):
        with jax_twins():
            return self.model.apply(qparams, x)


def _jax_qparams(sd):
    """The port's int8 state_dict as the JAX package's qparams tree (the
    inverse of ``qparams_from_jax``)."""
    tree = {"f4_scale": jnp.asarray(sd["f4_scale"].numpy())}
    for k, v in sd.items():
        if k != "f4_scale":
            stem, leaf = k.rsplit(".", 1)
            a = v.numpy()
            if leaf == "w_q":
                a = np.transpose(a, (1, 2, 3, 0))        # -> HWIO
            tree.setdefault(stem.replace(".", "/"), {})[leaf] = jnp.asarray(a)
    return tree


def test_int8_detect_batch_matches_jax():
    """The int8 landmark model, anchor-less (the bench's landmark pipeline:
    shared origins) at one scale, bf16 heatmaps (the 'auto' lm_dtype), the
    same int8 state on both sides: identical."""
    x = torch.from_numpy(IMG)
    sd = quantize_densebox(from_flax(_with_box_sized_loc(
        jax.jit(JaxDenseBox(Q_CFG).init)(jax.random.key(2), IMG)), Q_CFG),
        Q_CFG, x)
    model = QuantDenseBox(Q_CFG, device="cpu")
    model.load_state_dict(sd)
    with torch.inference_mode():
        refined = model.eval()(x)["refined"]
    label = LabelCfg(patch_size=64, std_height_px=20.0)
    infer = InferCfg(scales=(1.0,), topk_per_scale=64, pre_nms_topk=96,
                     max_dets=16, nms_backend="jax", lm_backend="jax",
                     score_thresh=float(np.quantile(refined.numpy(), 0.9)))
    want = jax_detector.detect_batch(_TwinForward(Q_CFG), _jax_qparams(sd),
                                     jnp.asarray(IMG), infer, label)
    with torch.inference_mode():
        got = detect_batch(model, x, infer, label)
    assert np.asarray(want["valid"]).sum() > 4
    assert np.asarray(want["lm_valid"]).sum() > 4
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
