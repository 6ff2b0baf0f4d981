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
import torch_threads  # noqa: F401  (sets torch's threads)

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


# --- the CUDA kernels' schedules, as numpy models ---------------------------
#
# csrc/labels.cu does not test every pixel against every row: the landmark
# kernel scatters each live row into the chunk of output a block owns, and
# the box kernel keeps, for a tile of 32 x 8 pixels, only the rows that can
# touch it. The models below follow those schedules in float32 and are held
# to the plain versions bit for bit; the GPU-marked tests of
# tests/test_torch_kernels.py hold the kernels themselves.

F = np.float32
EXACT_BELOW = F(2.0 ** 20)


def _reach(c, rad, lo_lim, hi_lim):
    """csrc/labels.cu:reach: the integers of [lo_lim, hi_lim] within
    rad + 1 of c, or None."""
    if not (abs(c) < EXACT_BELOW and rad < EXACT_BELOW):
        return lo_lim, hi_lim
    lo = max(F(np.floor(F(c - rad)) - F(1)), F(lo_lim))
    hi = min(F(np.ceil(F(c + rad)) + F(1)), F(hi_lim))
    return (int(lo), int(hi)) if lo <= hi else None


def _dist2(px, py, cx, cy):
    dx, dy = (px - cx).astype(F), (py - cy).astype(F)
    return (dx * dx).astype(F) + (dy * dy).astype(F)


def scatter_landmarks(rows, m, num_lm, chunk):
    """One patch's (M, M, L) landmark map by the kernel's schedule: rows
    (K*L, 3) float32, ``chunk`` output floats a block. Also returns the
    number of predicate tests made."""
    per = m * m * num_lm
    out = np.full(per, np.nan, F)
    tests = 0
    for start in range(0, per, chunk):
        n = min(chunk, per - start)
        tile = np.zeros(n, F)
        y_first, y_last = start // (m * num_lm), (start + n - 1) // (m * num_lm)
        for r, (lx, ly, r2) in enumerate(rows):
            if not r2 >= 0:
                continue
            with np.errstate(invalid="ignore", over="ignore"):
                rad = np.sqrt(F(r2))
                ys = _reach(ly, rad, y_first, y_last)
                xs = _reach(lx, rad, 0, m - 1)
                if ys is None or xs is None:
                    continue
                y, x = np.meshgrid(np.arange(ys[0], ys[1] + 1),
                                   np.arange(xs[0], xs[1] + 1), indexing="ij")
                hit = _dist2(x.astype(F), y.astype(F), lx, ly) <= r2
            tests += hit.size
            o = (y[hit] * m + x[hit]) * num_lm + r % num_lm - start
            tile[o[(o >= 0) & (o < n)]] = 1.0
        out[start:start + n] = tile
    return out.reshape(m, m, num_lm), tests


def tile_rows(rows, x0, y0, m):
    """The indices of the box rows (K, 8) that the kernel stages for the
    tile of 32 x 8 pixels at (x0, y0), in index order."""
    x_last, y_last = min(x0 + 31, m - 1), min(y0 + 7, m - 1)
    kept = []
    for i, (cx, cy, rc2, rg2) in enumerate(rows[:, :4]):
        reach2 = np.fmax(rc2, rg2)           # NaN loses, as CUDA's fmaxf
        if not reach2 >= 0:
            continue
        with np.errstate(over="ignore", invalid="ignore"):
            rad = F(np.sqrt(F(reach2)) + F(1))
            if (abs(cx) < EXACT_BELOW and abs(cy) < EXACT_BELOW
                    and rad < EXACT_BELOW and not (
                        F(cx + rad) >= x0 and F(cx - rad) <= x_last
                        and F(cy + rad) >= y0 and F(cy - rad) <= y_last)):
                continue
        kept.append(i)
    return kept


def tiled_boxes(rows, m, inv_norm):
    """One patch's score (M, M), loc (M, M, 4) and ignore (M, M) by the
    kernel's schedule: per tile the staged rows in index order, the running
    minimum replaced on strict ``<``. Also returns the rows walked per
    pixel, summed."""
    score, ignore = np.zeros((m, m), F), np.zeros((m, m), F)
    loc = np.zeros((m, m, 4), F)
    walked = 0
    for y0 in range(0, m, 8):
        for x0 in range(0, m, 32):
            ys, xs = np.arange(y0, min(y0 + 8, m)), np.arange(x0, min(x0 + 32, m))
            y, x = np.meshgrid(ys.astype(F), xs.astype(F), indexing="ij")
            best = np.full(y.shape, np.inf, F)
            box = np.zeros(y.shape + (4,), F)
            pos, gray = np.zeros(y.shape, bool), np.zeros(y.shape, bool)
            for i in tile_rows(rows, x0, y0, m):
                with np.errstate(invalid="ignore", over="ignore"):
                    d2 = _dist2(x, y, rows[i, 0], rows[i, 1])
                    gray |= d2 <= rows[i, 3]
                    pos_i = d2 <= rows[i, 2]
                    take = pos_i & (d2 < best)
                best = np.where(take, d2, best)
                box = np.where(take[..., None], rows[i, 4:], box)
                pos |= pos_i
                walked += y.size
            posf = pos.astype(F)
            sl = np.s_[y0:y0 + 8, x0:x0 + 32]
            score[sl], ignore[sl] = posf, (gray & ~pos).astype(F)
            with np.errstate(invalid="ignore", over="ignore"):
                loc[sl] = np.stack(
                    [(x - box[..., 0]) * F(inv_norm) * posf,
                     (y - box[..., 1]) * F(inv_norm) * posf,
                     (box[..., 2] - x) * F(inv_norm) * posf,
                     (box[..., 3] - y) * F(inv_norm) * posf], -1)
    return score, loc, ignore, walked


def _bits(a):
    return np.ascontiguousarray(a, F).view(np.int32)


def _check_models(rows, lm_rows, m, num_lm, chunk=None):
    """Both models against the plain versions on (B, K, 8) and (B, K*L, 3)
    rows, bit for bit; returns the work the schedules did."""
    inv = F(1 / 12.5)
    if chunk is None:
        chunk = klabels.landmark_chunk(m, num_lm, len(rows))[0]
    want = klabels.rasterize_boxes_reference(torch.from_numpy(rows), m,
                                             float(inv))
    want_lm = klabels.rasterize_landmarks_reference(torch.from_numpy(lm_rows),
                                                    m, num_lm).numpy()
    tests = walked = 0
    for b in range(len(rows)):
        score, loc, ignore, w = tiled_boxes(rows[b], m, inv)
        for got, ref, name in ((score, want[0][b, ..., 0], "score"),
                               (loc, want[1][b], "loc"),
                               (ignore, want[2][b, ..., 0], "ignore")):
            np.testing.assert_array_equal(_bits(got), _bits(ref.numpy()),
                                          err_msg=f"{name} of patch {b}")
        lm, t = scatter_landmarks(lm_rows[b], m, num_lm, chunk)
        np.testing.assert_array_equal(_bits(lm), _bits(want_lm[b]),
                                      err_msg=f"lm of patch {b}")
        tests, walked = tests + t, walked + w
    return tests, walked


def _label_rows(case, b, k, m, num_lm):
    from kernel_cases import label_rows

    rows, lm_rows = label_rows(np.random.RandomState(17), b, k, m, num_lm,
                               quarter=case == "quarter_grid")
    if case == "all_invalid":
        rows[..., 2:4] = -1.0
        lm_rows[..., 2] = -1.0
    return rows, lm_rows


@pytest.mark.parametrize("case,b,k,m,num_lm", [
    ("train", 4, 16, 60, 5), ("ragged", 3, 1, 8, 1),
    ("quarter_grid", 4, 16, 60, 5), ("all_invalid", 2, 16, 60, 5),
    ("m125_k1024", 1, 1024, 125, 1), ("m125_kl1024", 1, 256, 125, 4),
    ("one_pixel", 2, 2, 1, 1), ("m33", 2, 5, 33, 2)])
def test_kernel_schedules_equal_the_plain_versions(case, b, k, m, num_lm):
    """The rasterizer cases of ``kernel_cases.label_rows`` (quarter grid,
    every slot invalid, the edges of the staging passes), through the numpy
    models of the two kernels' schedules."""
    rows, lm_rows = _label_rows(case, b, k, m, num_lm)
    tests, walked = _check_models(rows, lm_rows, m, num_lm)
    if case == "all_invalid":
        assert tests == 0 and walked == 0       # nothing staged, nothing tested
    if case == "train":
        # the scatter tests a few pixels a live row, not every pixel
        assert 0 < tests < b * k * num_lm * 40
        assert 0 < walked < b * m * m * k


@pytest.mark.parametrize("chunk", [1800, 3600, 1024, 40, 100])
def test_landmark_scatter_on_chunk_edges(chunk):
    """A centre at every quarter pixel from 3 above to 3 below each map row
    where a chunk ends, at columns inside, on the rim of and outside the
    map, with squared radii 0, 0.25, 1, 2.25 and 6.25."""
    from kernel_cases import LM_R2, landmark_edge_rows

    m, num_lm, k = (60, 5, 16) if chunk >= 1024 else (8, 3, 4)
    lm_rows = landmark_edge_rows(m, num_lm, k, chunk)
    assert set(np.unique(lm_rows[..., 2])) >= set(F(LM_R2))
    assert lm_rows[..., 0].min() == -2 and lm_rows[..., 0].max() == m + 2
    want = klabels.rasterize_landmarks_reference(torch.from_numpy(lm_rows), m,
                                                 num_lm).numpy()
    assert want.sum() > 0
    for b in range(len(lm_rows)):
        got, _ = scatter_landmarks(lm_rows[b], m, num_lm, chunk)
        np.testing.assert_array_equal(_bits(got), _bits(want[b]),
                                      err_msg=f"patch {b}")


def test_schedules_with_huge_and_non_finite_rows():
    """Centres and radii of 2^20 and more, infinities, NaN and -0.0: the
    models give up culling where float sums stop being exact and still equal
    the plain versions (compared as bits, so NaN targets count)."""
    m, num_lm = 12, 2
    inf, nan = np.inf, np.nan
    rows = np.array([[
        [5, 5, 4, 16, 1, 1, 9, 9], [3e6, 5, 9e12, 9.1e12, 0, 0, 1, 1],
        [5, -2e6, 4.1e12, -1, 0, 0, 1, 1], [nan, 5, 4, 16, 1, 1, 9, 9],
        [6, 6, nan, 9, 2, 2, 8, 8], [7, 7, inf, inf, 3, 3, 9, 9],
        [2, 2, -0.0, -0.0, 1, 1, 3, 3], [8, 3, nan, nan, 1, 1, 3, 3],
        [4, 9, 1, 4, -inf, 0, inf, nan]]], F)
    lm_rows = np.array([[
        [5, 5, 1], [1e7, 5, 1e14], [nan, 5, 1], [5, nan, 1], [5, 5, nan],
        [3, 3, inf], [2, 7, -0.0], [-3e6, 6, 9.1e12], [6, 6, 0],
        [7.5, 7.5, 0.5]]], F)
    _check_models(rows, lm_rows, m, num_lm, chunk=100)
    # each row alone too, so that none hides behind another
    for i in range(rows.shape[1]):
        _check_models(rows[:, i:i + 1], lm_rows[:, :2], m, num_lm, chunk=100)
    for i in range(0, lm_rows.shape[1], 2):
        _check_models(rows[:, :1], lm_rows[:, i:i + 2], m, num_lm, chunk=52)


def test_tile_rows_keep_index_order_and_drop_what_cannot_touch():
    rows = np.zeros((6, 8), F)
    rows[:, :4] = [[50, 50, 4, 16], [3, 3, 4, 16], [40, 4, -1, 9],
                   [3, 3, -1, -1], [20, 20, 400, -1], [33, 9, 1, 1]]
    assert tile_rows(rows, 0, 0, 60) == [1, 4, 5]
    assert tile_rows(rows, 32, 0, 60) == [2, 4, 5]
    assert tile_rows(rows, 32, 48, 60) == [0]
    assert tile_rows(rows, 0, 56, 60) == []


@pytest.mark.parametrize("args,want", [
    ((60, 5, 32), (1800, 10)), ((60, 5, 1), (1024, 18)),
    ((8, 1, 3), (64, 1)), ((1, 1, 1), (4, 1)), ((4096, 5, 1), (6140, 13663)),
    ((60, 5, 256), (6000, 3)), ((125, 5, 2), (1024, 77))])
def test_landmark_chunk_rule(args, want):
    chunk, blocks = klabels.landmark_chunk(*args)
    assert (chunk, blocks) == want
    per = args[0] * args[0] * args[1]
    assert chunk % 4 == 0 and 4 <= chunk <= klabels.LM_MAX_CHUNK
    assert (blocks - 1) * chunk < per <= blocks * chunk


@pytest.mark.parametrize("num_lm", [1, 5])
def test_quarter_pixel_landmarks_identical_to_jax(num_lm):
    """Landmarks at every quarter of a map pixel (whole px, at stride 4)
    from outside the patch to outside it again, through ``rasterize`` and
    JAX's ``rasterize_batch`` called without jit; and the scatter model on
    the same packed rows."""
    cfg = LabelCfg(**SMALL)                          # 16 x 16 maps
    k = 3
    coords = np.arange(-8, 72, dtype=F)              # px: map -2 .. 17.75
    xs = np.resize(coords, (k, num_lm, coords.size))
    lms = np.stack([xs, np.roll(xs, 7, -1) * F(0.5) + F(8)], -1)
    lms = lms.transpose(2, 0, 1, 3)                  # (B, K, L, 2)
    b = lms.shape[0]
    boxes = np.tile(np.array([[20, 20, 40, 40], [10, 8, 30, 28],
                              [0, 0, 60, 60]], F), (b, 1, 1))   # last: out of band
    valid = np.ones((b, k), bool)
    lmv = np.ones((b, k, num_lm), bool)
    lmv[::5, 0] = False
    got = _port(boxes, valid, cfg, lms, lmv)
    want = _jax(rasterize_batch, boxes, valid, JaxLabelCfg(**SMALL), lms, lmv)
    assert want["lm"].sum() > 0
    _assert_identical(got, want)
    lm_rows = klabels.pack_landmarks(*(torch.from_numpy(a) for a in (
        boxes, valid, lms, lmv)), cfg).numpy()
    for i in range(0, b, 9):
        for chunk in (64, 100):
            model, _ = scatter_landmarks(lm_rows[i], cfg.map_size, num_lm,
                                         chunk - chunk % 4)
            np.testing.assert_array_equal(model, got["lm"][i])


def test_rasterize_maps_is_both_wrappers():
    from kernel_cases import label_rows

    rows, lm_rows = (torch.from_numpy(a) for a in label_rows(
        np.random.RandomState(3), 2, 4, 16, 3))
    got = klabels.rasterize_maps(rows, lm_rows, 16, 0.08, 3)
    want = klabels.rasterize_boxes(rows, 16, 0.08) + (
        klabels.rasterize_landmarks(lm_rows, 16, 3),)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="rasterize_maps"):
        klabels.rasterize_maps(rows, lm_rows[:1], 16, 0.08, 3)
    with pytest.raises(ValueError, match="rasterize_maps"):
        klabels.rasterize_maps(rows, lm_rows[:, :9], 16, 0.08, 3)
    with pytest.raises(ValueError, match="rasterize_landmarks"):
        klabels.rasterize_maps(rows, lm_rows, 16, 0.08, 5)
