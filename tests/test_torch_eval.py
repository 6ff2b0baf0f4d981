"""The port's ``eval.py`` (and the CLI's landmark matching) against the JAX
package's, function by function.

Inputs: the hand-made cases of ``tests/test_eval.py`` and random ones from
numpy seeds (clustered boxes so that matches, duplicates, ignored GTs and
DontCare overlaps all occur, score ties included). Bar: equal results
(floats bit for bit, NaN where JAX gives NaN); ``detections_to_numpy``
also takes the port's torch tensors.
"""

import math

import numpy as np
import pytest
import torch

from densebox_tpu import cli as jax_cli
from densebox_tpu import eval as jax_eval
from densebox_tpu_torch import cli
from densebox_tpu_torch import eval as port_eval

SEEDS = range(8)


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, float):
        assert isinstance(got, float)
        assert (math.isnan(got) and math.isnan(want)) or got == want
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _both(name, *args, **kw):
    got = getattr(port_eval, name)(*args, **kw)
    want = getattr(jax_eval, name)(*args, **kw)
    _same(got, want)
    return got


def _boxes(rng, n, spread=200.0):
    ctr = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def _image(rng, with_meta=True):
    g = rng.randint(0, 7)
    gt = _boxes(rng, g)
    p = rng.randint(0, 12)
    near = gt[rng.randint(0, max(g, 1), p)] if g else _boxes(rng, p)
    pred = (near + rng.normal(0, 4, near.shape)).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, p), 1).astype(np.float32)  # ties
    item = {"pred_boxes": pred, "pred_scores": scores, "gt_boxes": gt}
    if with_meta:
        item["gt_truncation"] = rng.choice([0.0, 0.2, 0.4, 0.6], g)
        item["gt_occlusion"] = rng.randint(0, 4, g)
        item["dontcare"] = _boxes(rng, rng.randint(0, 3))
    return item


HAND_GT = np.array([[0., 0., 10., 10.], [20., 20., 30., 30.]])
HAND_PRED = np.array([[0., 0., 10., 10.], [1., 1., 11., 11.],
                      [50., 50., 60., 60.]])


@pytest.mark.parametrize("seed", SEEDS)
def test_match_image(seed):
    _both("match_image", HAND_PRED, np.array([0.9, 0.8, 0.7]), HAND_GT, 0.5)
    rng = np.random.RandomState(seed)
    it = _image(rng, with_meta=False)
    for thr in (0.3, 0.5, 0.7):
        _both("match_image", it["pred_boxes"], it["pred_scores"],
              it["gt_boxes"], thr)


@pytest.mark.parametrize("seed", SEEDS)
def test_average_precision_and_r40(seed):
    for name in ("average_precision", "average_precision_r40"):
        _both(name, np.array([0.9, 0.8]), np.array([True, True]), 2)
        _both(name, np.array([0.9]), np.array([False]), 2)
        _both(name, np.array([0.9, 0.8]), np.array([False, True]), 2)
        _both(name, np.zeros(0), np.zeros(0, bool), 2)
        _both(name, np.zeros(0), np.zeros(0, bool), 0)
        rng = np.random.RandomState(seed)
        n = rng.randint(1, 60)
        scores = np.round(rng.uniform(0, 1, n), 2)
        tp = rng.uniform(0, 1, n) < 0.5
        _both(name, scores, tp, int(tp.sum()) + rng.randint(0, 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_detections(seed):
    rng = np.random.RandomState(seed)
    items = [_image(rng, with_meta=False) for _ in range(rng.randint(1, 6))]
    for thr in (0.5, 0.7):
        _both("evaluate_detections", items, iou_thresh=thr)
    _both("evaluate_detections", [])


@pytest.mark.parametrize("seed", SEEDS)
def test_match_image_kitti(seed):
    gt = np.array([[0., 0., 50., 50.], [100., 0., 110., 10.]])
    pred = np.array([[0., 0., 50., 50.], [100., 0., 110., 10.],
                     [205., 205., 255., 255.], [300., 300., 310., 310.],
                     [400., 300., 440., 340.]])
    _both("match_image_kitti", pred, np.array([0.9, 0.8, 0.7, 0.6, 0.5]),
          gt, np.array([False, True]), np.array([[200., 200., 260., 260.]]),
          iou_thresh=0.5, min_height=25.0)
    _both("match_image_kitti", np.array([[1., 1., 40., 40.]]),
          np.array([0.9]), np.array([[0., 0., 40., 40.], [2., 2., 40., 40.]]),
          np.array([False, True]), np.zeros((0, 4)), 0.5, 25.0)
    rng = np.random.RandomState(seed)
    it = _image(rng)
    ignored = rng.uniform(0, 1, len(it["gt_boxes"])) < 0.3
    for thr, min_h in ((0.5, 25.0), (0.7, 40.0)):
        _both("match_image_kitti", it["pred_boxes"], it["pred_scores"],
              it["gt_boxes"], ignored, it["dontcare"], thr, min_h)


@pytest.mark.parametrize("seed", SEEDS)
def test_evaluate_kitti(seed):
    gt = np.array([[0., 0., 50., 50.], [100., 0., 130., 30.],
                   [200., 0., 230., 30.], [300., 0., 320., 20.]])
    hand = {"pred_boxes": gt.copy(),
            "pred_scores": np.array([0.9, 0.8, 0.7, 0.6]), "gt_boxes": gt,
            "gt_truncation": np.array([0.0, 0.0, 0.4, 0.0]),
            "gt_occlusion": np.array([0, 1, 2, 0]),
            "dontcare": np.zeros((0, 4))}
    res = _both("evaluate_kitti", [hand], iou_thresh=0.7)
    assert res["n_gt_hard"] == 3.0
    rng = np.random.RandomState(seed)
    items = [_image(rng, with_meta=bool(i % 2)) for i in range(5)]
    for thr in (0.5, 0.7):
        _both("evaluate_kitti", items, iou_thresh=thr)


@pytest.mark.parametrize("device_tensors", [False, True])
def test_detections_to_numpy(device_tensors):
    rng = np.random.RandomState(1)
    dets = {"boxes": rng.uniform(0, 99, (3, 8, 4)).astype(np.float32),
            "scores": rng.uniform(0, 1, (3, 8)).astype(np.float32),
            "valid": rng.uniform(0, 1, (3, 8)) < 0.5}
    gts = rng.uniform(0, 99, (3, 5, 4)).astype(np.float32)
    gv = rng.uniform(0, 1, (3, 5)) < 0.5
    want = jax_eval.detections_to_numpy(dets, gts, gv)
    if device_tensors:
        dets = {k: torch.from_numpy(v) for k, v in dets.items()}
        gts, gv = torch.from_numpy(gts), torch.from_numpy(gv)
    _same(port_eval.detections_to_numpy(dets, gts, gv), want)


def test_heatmap_mse_and_landmark_nme():
    rng = np.random.RandomState(2)
    a = {"score": rng.rand(2, 4, 4, 1), "loc": rng.rand(2, 4, 4, 4)}
    b = {"score": rng.rand(2, 4, 4, 1), "lm": rng.rand(2, 4, 4, 3)}
    _both("heatmap_mse", a, b)
    assert port_eval.heatmap_mse(
        {k: torch.from_numpy(v) for k, v in a.items()}, b) == \
        jax_eval.heatmap_mse(a, b)
    gt = np.array([[[0., 0.], [10., 0.]]])
    pred = np.array([[[3., 4.], [10., 0.]]])
    assert _both("landmark_nme", pred, gt, np.array([10.0])) == 0.25
    pred, gt = rng.rand(6, 5, 2) * 50, rng.rand(6, 5, 2) * 50
    norm, mask = rng.rand(6) * 30, rng.rand(6, 5) < 0.5
    _both("landmark_nme", pred, gt, norm)
    _both("landmark_nme", pred, gt, norm, mask=mask)
    _both("landmark_nme", pred, gt, norm, mask=np.zeros((6, 5), bool))


@pytest.mark.parametrize("seed", range(4))
def test_match_landmarks_equals_jax(seed):
    """The CLI's NME pairing: detections past the lm_topk cap (lm_valid all
    False) are left out, the GT of highest IoU >= 0.5 is taken."""
    rng = np.random.RandomState(seed)
    b, d, k, num_lm = 2, 6, 4, 3
    gt = np.stack([_boxes(rng, k, 60) for _ in range(b)])
    boxes = (gt[:, rng.randint(0, k, d)]
             + rng.normal(0, 3, (b, d, 4))).astype(np.float32)
    dets = {"boxes": boxes, "valid": rng.rand(b, d) < 0.8,
            "lm_points": rng.rand(b, d, num_lm, 2).astype(np.float32) * 60,
            "lm_valid": rng.rand(b, d, num_lm) < 0.7}
    batch = {"boxes": gt, "box_valid": rng.rand(b, k) < 0.8,
             "landmarks": rng.rand(b, k, num_lm, 2).astype(np.float32) * 60,
             "lm_valid": rng.rand(b, k, num_lm) < 0.8}
    want = jax_cli._match_landmarks(dets, batch)
    got = cli._match_landmarks(
        {k: torch.from_numpy(v) for k, v in dets.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            np.testing.assert_array_equal(np.asarray(gv), np.asarray(wv))
