"""The port's GT rasterizer against the JAX package's, on the CPU.

The same numpy boxes and landmarks go through
``densebox_tpu_torch.ops.labels.rasterize`` (the kernels' plain versions:
the tensors are on the CPU) and through JAX's ``rasterize_batch`` called
directly (eager, so that each float operation rounds on its own) and
``rasterize_batch_pallas`` (interpret mode). Bar: every map identical
(``assert_array_equal``; tolerance 0), because one ulp of a squared distance
flips a pixel on a disc's rim; the rim and tie cases are built so that
``d2 == rc2`` holds exactly in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import LabelCfg as JaxLabelCfg
from densebox_tpu.ops.labels import rasterize_batch
from densebox_tpu.ops.pallas.labels import _pack_boxes, rasterize_batch_pallas
from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.ops.decode import decode_topk
from densebox_tpu_torch.ops.kernels import labels as klabels
from densebox_tpu_torch.ops.labels import rasterize
from test_labels import _rand_instances, numpy_rasterize

SMALL = dict(patch_size=64, std_height_px=20.0)     # 16x16 maps


def _port(boxes, valid, cfg, lms=None, lmv=None):
    t = [None if a is None else torch.from_numpy(np.asarray(a))
         for a in (boxes, valid, lms, lmv)]
    return {k: v.numpy() for k, v in
            rasterize(t[0], t[1], cfg, t[2], t[3]).items()}


def _jax(fn, boxes, valid, cfg, lms=None, lmv=None):
    j = [None if a is None else jnp.asarray(a) for a in (boxes, valid, lms, lmv)]
    return {k: np.asarray(v) for k, v in fn(j[0], j[1], cfg, j[2], j[3]).items()}


def _assert_identical(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("num_lm", [0, 3, 5])
@pytest.mark.parametrize("jax_fn", [rasterize_batch, rasterize_batch_pallas],
                         ids=["twin_eager", "pallas_interpret"])
def test_rasterize_identical_to_jax(num_lm, jax_fn):
    for seed in (0, 1, 2):
        boxes, valid, lms, lmv = _rand_instances(seed, b=3, k=4, num_lm=num_lm,
                                                 cfg=JaxLabelCfg(**SMALL))
        got = _port(boxes, valid, LabelCfg(**SMALL), lms, lmv)
        want = _jax(jax_fn, boxes, valid, JaxLabelCfg(**SMALL), lms, lmv)
        assert want["score"].sum() > 0 and want["ignore"].sum() > 0
        _assert_identical(got, want)


def test_rasterize_without_lm_valid_and_full_size():
    """lm_valid=None means every landmark visible; and the preset geometry
    (240 px, 60x60 maps, K=16)."""
    boxes, valid, lms, _ = _rand_instances(5, b=2, k=16, num_lm=5,
                                           cfg=JaxLabelCfg())
    got = _port(boxes, valid, LabelCfg(), lms)
    want = _jax(rasterize_batch, boxes, valid, JaxLabelCfg(), lms)
    assert got["lm"].shape == (2, 60, 60, 5) and want["lm"].sum() > 0
    _assert_identical(got, want)


# rc_ratio 0.5: a 24 px box is 6 map units high, rc = 3, rc + rnear = 5, so
# integer centres put pixels exactly on both rims (3-4-5 triangles)
RIM = dict(patch_size=64, std_height_px=24.0, rc_ratio=0.5)
RIM_CASES = {
    "rim_exact": [[8., 4., 32., 28.]],                    # centre (5, 4)
    "half_integer_rim": [[10., 4., 34., 28.]],            # centre (5.5, 4)
    "coincident_centres": [[8., 4., 32., 28.], [4., 4., 36., 28.]],
    "equidistant_centres": [[4., 8., 28., 32.], [20., 8., 44., 32.]],
    "out_of_band_over_in_band": [[8., 4., 32., 28.], [0., 0., 60., 60.]],
}


@pytest.mark.parametrize("case", sorted(RIM_CASES))
def test_rim_and_tie_cases_identical(case):
    boxes = np.array([RIM_CASES[case]], np.float32)
    valid = np.ones(boxes.shape[:2], bool)
    lms = np.stack([boxes[..., :2], boxes[..., 2:]], 2)   # corners, on pixels
    lmv = np.ones(lms.shape[:3], bool)
    got = _port(boxes, valid, LabelCfg(**RIM), lms, lmv)
    for fn in (rasterize_batch, rasterize_batch_pallas):
        _assert_identical(got, _jax(fn, boxes, valid, JaxLabelCfg(**RIM),
                                    lms, lmv))
    score, ign = got["score"][0, :, :, 0], got["ignore"][0, :, :, 0]
    if case == "rim_exact":
        # (5+3, 4) and (5, 4+3) lie on the positive rim, (5+3, 4+4) and
        # (5+5, 4) on the gray rim
        assert score[4, 8] == score[7, 5] == 1 and score[4, 9] == 0
        assert ign[8, 8] == ign[4, 10] == 1 and ign[4, 11] == 0
    if case == "equidistant_centres":
        # column x = 4 is 2 from both centres (2, 5) and (6, 5): box 0 wins
        assert score[5, 4] == 1
        np.testing.assert_array_equal(
            got["loc"][0, 5, 4],
            (np.float32([4 - 1, 5 - 2, 7 - 4, 8 - 5]) * np.float32(1 / 6.0)))
    if case == "coincident_centres":
        assert got["loc"][0, 4, 5, 0] == np.float32(3) * np.float32(1 / 6.0)


def test_pack_boxes_identical():
    boxes, valid, _, _ = _rand_instances(7, b=4, k=6, cfg=JaxLabelCfg(**SMALL))
    # heights exactly on the band's ends (16 and 25 px) stay in band
    boxes[0, 0] = [8, 8, 28, 24]
    boxes[0, 1] = [8, 8, 28, 33]
    valid[0, :2] = True
    want = np.asarray(_pack_boxes(jnp.asarray(boxes), jnp.asarray(valid),
                                  JaxLabelCfg(**SMALL)))
    got = klabels.pack_boxes(torch.from_numpy(boxes), torch.from_numpy(valid),
                             LabelCfg(**SMALL)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 2] > 0 and got[0, 1, 2] > 0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("num_lm", [0, 3])
def test_matches_numpy_loop_reference(seed, num_lm):
    """The per-pixel numpy loop of tests/test_labels.py (float64): 1e-5."""
    cfg = JaxLabelCfg(**SMALL)
    boxes, valid, lms, lmv = _rand_instances(seed, num_lm=num_lm, cfg=cfg)
    want = numpy_rasterize(boxes, valid, cfg, lms, lmv)
    got = _port(boxes, valid, LabelCfg(**SMALL), lms, lmv)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, err_msg=key)


def test_properties_nearest_centre_out_of_band_empty():
    cfg = LabelCfg(**SMALL)
    boxes = np.array([[[10., 10., 30., 30.], [22., 10., 42., 30.]]], np.float32)
    out = _port(boxes, np.ones((1, 2), bool), cfg)
    d = out["loc"][0, 5, 5] * cfg.loc_norm * cfg.stride
    assert out["score"][0, 5, 5, 0] == 1.0
    np.testing.assert_allclose([20 - d[0], 20 - d[1], 20 + d[2], 20 + d[3]],
                               boxes[0, 0], atol=1e-4)
    big = np.array([[[100., 60., 140., 180.]]], np.float32)   # far out of band
    out = _port(big, np.ones((1, 1), bool), LabelCfg())
    assert out["score"].sum() == 0 and out["ignore"].sum() > 0
    out = _port(np.zeros((1, 4, 4), np.float32), np.zeros((1, 4), bool), cfg)
    assert all(out[k].sum() == 0 for k in ("score", "ignore", "loc_mask"))
    assert np.abs(out["loc"]).sum() == 0


def test_decode_rasterize_roundtrip():
    """decode(rasterize(box)) recovers the box at every positive pixel."""
    cfg = LabelCfg(**SMALL)
    boxes, valid, _, _ = _rand_instances(3, b=1, k=1, cfg=JaxLabelCfg(**SMALL))
    valid[:] = True
    boxes[0, 0, 3] = boxes[0, 0, 1] + cfg.std_height_px
    out = rasterize(torch.from_numpy(boxes), torch.from_numpy(valid), cfg)
    db, _, dv = decode_topk(out["score"], out["loc"], stride=cfg.stride,
                            loc_norm=cfg.loc_norm, topk=16, score_thresh=0.5)
    assert int(out["score"].sum()) > 0 and bool(dv.any())
    for g in db[dv].numpy():
        np.testing.assert_allclose(g, boxes[0, 0], atol=1e-3)


def test_rasterize_checks_shapes():
    cfg = LabelCfg(**SMALL)
    b = torch.zeros(2, 3, 4)
    v = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="boxes"):
        rasterize(b[..., :3], v, cfg)
    with pytest.raises(ValueError, match="box_valid"):
        rasterize(b, v.float(), cfg)
    with pytest.raises(ValueError, match="landmarks"):
        rasterize(b, v, cfg, torch.zeros(2, 4, 5, 2))
    with pytest.raises(ValueError, match="lm_valid"):
        rasterize(b, v, cfg, torch.zeros(2, 3, 5, 2),
                  torch.ones(2, 3, 4, dtype=torch.bool))
