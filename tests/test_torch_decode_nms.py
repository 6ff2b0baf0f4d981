"""The port's decode and NMS against the JAX package's.

Decode: same maps in, identical top-k order (ties: lower index first, as
lax.top_k), identical valid bits, boxes to 1e-5. NMS: the port's ``nms``
(plain keep mask on the CPU) against ``densebox_tpu.ops.nms.nms`` and the
Pallas ``nms_pallas`` in interpret mode — keep sets, output indices, valid
bits, boxes and scores identical (for float pairs on the IoU threshold, see
test_nms_float_threshold_pairs_match_jax_op_by_op). The CUDA kernel is held
against the plain version in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.ops.decode import decode_topk as jax_decode_topk
from densebox_tpu.ops.nms import iou_matrix as jax_iou_matrix
from densebox_tpu.ops.nms import nms as jax_nms
from densebox_tpu.ops.pallas.nms import greedy_keep_pallas, nms_pallas
from densebox_tpu_torch.ops.decode import decode_topk, topk_stable
from densebox_tpu_torch.ops.kernels import nms as knms
from densebox_tpu_torch.ops.nms import iou_matrix, nms
from test_torch_kernels import random_boxes as _random_boxes
from test_torch_kernels import threshold_boxes as _threshold_boxes


def _maps(seed, b, h, w):
    rng = np.random.RandomState(seed)
    # two decimals: many duplicated scores, so tie order is exercised
    score = np.round(rng.uniform(-1, 1, (b, h, w, 1)), 2).astype(np.float32)
    loc = rng.uniform(-0.2, 1.5, (b, h, w, 4)).astype(np.float32)
    return score, loc


@pytest.mark.parametrize("hw,topk", [((12, 16), 64), ((6, 8), 64),
                                     ((12, 16), 192)])
def test_decode_topk_matches_jax(hw, topk):
    score, loc = _maps(sum(hw) + topk, 3, *hw)
    kw = dict(stride=4, loc_norm=12.5, topk=topk, score_thresh=0.1,
              scale_x=1.25, scale_y=0.75)
    want = [np.asarray(a) for a in jax.vmap(
        lambda s, l: jax_decode_topk(s, l, **kw))(score, loc)]
    got = [t.numpy() for t in decode_topk(torch.from_numpy(score),
                                          torch.from_numpy(loc), **kw)]
    np.testing.assert_array_equal(got[1], want[1])          # scores, order
    np.testing.assert_array_equal(got[2], want[2])          # valid
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)


def test_topk_stable_tie_order_matches_lax():
    x = np.round(np.random.RandomState(0).rand(4, 300), 1).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 50)
    got_v, got_i = topk_stable(torch.from_numpy(x), 50)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _integer_threshold_boxes(seed, b, k):
    return _threshold_boxes(seed, b, k, integer_frac=1.0)


def _port_nms(boxes, scores, valid, max_out):
    return [t.numpy() for t in nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(valid), iou_thresh=0.5, max_out=max_out,
        return_idx=True)]


def _jax_nms(fn, boxes, scores, valid, max_out, jit=True):
    f = jax.vmap(lambda b, s, v: fn(
        b, s, v, iou_thresh=0.5, max_out=max_out, return_idx=True))
    out = (jax.jit(f) if jit else f)(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    return [np.asarray(a) for a in out]


def _pallas_interpret(b, s, v, **kw):
    return nms_pallas(b, s, v, interpret=True, **kw)


def _assert_same(got, want):
    for name, g, w in zip(("boxes", "scores", "valid", "idx"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("kind", ["random", "threshold_integer"])
@pytest.mark.parametrize("k", [8, 256, 512])
def test_nms_matches_jax_and_pallas(kind, k):
    make = _random_boxes if kind == "random" else _integer_threshold_boxes
    boxes, scores, valid = make(k, 3, k)
    max_out = {8: 12, 256: 260, 512: 128}[k]       # past K, and truncating
    got = _port_nms(boxes, scores, valid, max_out)
    assert got[2].any()
    if kind == "random" and k == 256:               # NMS did suppress
        assert got[2].sum() < valid.sum()
    _assert_same(got, _jax_nms(jax_nms, boxes, scores, valid, max_out))
    _assert_same(got, _jax_nms(_pallas_interpret, boxes, scores, valid,
                               max_out))


@pytest.mark.parametrize("k", [256, 512])
def test_nms_float_threshold_pairs_match_jax_op_by_op(k):
    """Float pairs whose IoU f32 rounds to either side of 0.5. The port (and
    the CUDA kernel, built without FMA contraction) rounds every operation
    of iou_matrix on its own, as JAX does run op by op. Compiled, XLA's CPU
    backend contracts ``area_i + w_j * h_j`` into one FMA (in ``nms`` under
    jit and in the Pallas interpret kernel alike), which moves about 0.3%
    of these IoUs by one ulp; so the reference here is JAX without jit."""
    boxes, scores, valid = _threshold_boxes(k, 3, k)
    got = _port_nms(boxes, scores, valid, k + 4)
    assert 0 < got[2].sum() < valid.sum()
    _assert_same(got, _jax_nms(jax_nms, boxes, scores, valid, k + 4,
                               jit=False))


def test_iou_matrix_matches_jax_op_by_op():
    boxes, _, _ = _threshold_boxes(0, 1, 256)
    want = np.asarray(jax_iou_matrix(jnp.asarray(boxes[0]),
                                     jnp.asarray(boxes[0])))
    got = iou_matrix(torch.from_numpy(boxes[0]), torch.from_numpy(boxes[0]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_threshold_pairs_hit_both_sides():
    """The boundary set really probes the threshold: some pairs round to
    exactly 0.5 (kept), some above (suppressed)."""
    boxes, _, _ = _threshold_boxes(0, 1, 256)
    pairs = torch.from_numpy(boxes[0]).reshape(-1, 2, 4)
    iou = iou_matrix(pairs[:, :1], pairs[:, 1:])[:, 0, 0]
    assert (iou == 0.5).any() and (iou > 0.5).any()


def test_greedy_keep_reference_matches_pallas_kernel():
    boxes, scores, valid = _random_boxes(7, 2, 256)
    order = np.argsort(-np.where(valid, scores, -np.inf), axis=1, kind="stable")
    boxes = np.take_along_axis(boxes, order[..., None], 1)
    valid = np.take_along_axis(valid, order, 1)
    want = np.stack([np.asarray(greedy_keep_pallas(
        jnp.asarray(boxes[i]), jnp.asarray(valid[i]), 0.5, interpret=True))
        for i in range(2)])
    before = knms.launches
    got = knms.greedy_keep(torch.from_numpy(boxes), torch.from_numpy(valid),
                           0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert knms.launches == before      # the CPU path launches nothing


@pytest.mark.parametrize("max_out", [8, 20])
def test_nms_empty_input(max_out):
    """No valid candidate: every slot invalid, and the filler boxes, scores
    and indices are JAX's (tie order of the all -inf scores)."""
    boxes, scores, _ = _random_boxes(11, 2, 16)
    valid = np.zeros((2, 16), bool)
    got = _port_nms(boxes, scores, valid, max_out)
    assert not got[2].any() and got[0].shape == (2, max_out, 4)
    _assert_same(got, _jax_nms(jax_nms, boxes, scores, valid, max_out))
    _assert_same(got, _jax_nms(_pallas_interpret, boxes, scores, valid,
                               max_out))


def test_greedy_keep_rejects_other_devices():
    meta = torch.zeros(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        knms.greedy_keep(meta, torch.ones(1, 8, dtype=torch.bool,
                                          device="meta"), 0.5)
