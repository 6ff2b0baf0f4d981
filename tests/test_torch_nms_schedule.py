"""A numpy model of the greedy-NMS kernel's schedule (csrc/nms.cu), held to
the plain version and to the JAX package's Pallas kernel.

The model follows the kernel step by step: the launch shape
(``launch_shape``), which CTA of an image's cluster and which warp builds
each box's in-edge words, which half-words it tests, the words in CTA 0's
shared memory (those no warp stores hold garbage), and the sweep over
64-box tiles (the hits by kept boxes of earlier tiles, then the fixed point
over kept and undecided boxes within the tile). Its keep masks must equal
``greedy_keep_reference`` and ``greedy_keep_pallas(interpret=True)`` bit
for bit on every set of ``chip_smoke.nms_set`` at K from 1 to 1024; the
card holds the kernel to the same sets (tests/test_torch_kernels.py,
chip_smoke.py phase 4). Change kernel and model together.

The Pallas kernel runs jitted, where XLA contracts an FMA that moves a
float pair on the IoU threshold by one ulp (test_torch_decode_nms.py), so
it is compared on the sets without such pairs and on integer pairs at
exactly 0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NMS_SETS, nms_set, threshold_case
from densebox_tpu.ops.pallas.nms import greedy_keep_pallas
from densebox_tpu_torch.ops.kernels import nms as knms

LANES = np.arange(32, dtype=np.uint64)
ONE = np.uint64(1)
KS = (1, 63, 64, 65, 97, 100, 256, 512, 1024)   # 97: one box past a half


def hits_matrix(boxes, thresh):
    """IoU(i, j) > thresh for every pair of one image's (K, 4) boxes, with
    the kernel's operations in float32 (numpy contracts no FMA)."""
    f32 = np.float32
    x1, y1, x2, y2 = boxes.T
    area = np.maximum(x2 - x1, f32(0)) * np.maximum(y2 - y1, f32(0))
    iw = np.maximum(np.minimum(x2[:, None], x2[None])
                    - np.maximum(x1[:, None], x1[None]), f32(0))
    ih = np.maximum(np.minimum(y2[:, None], y2[None])
                    - np.maximum(y1[:, None], y1[None]), f32(0))
    inter = iw * ih
    union = (area[:, None] + area[None]) - inter
    none = inter == 0      # no division: +0 (the division's slow path)
    q = np.where(none, f32(1), inter) / np.maximum(union, f32(1e-9))
    return np.where(none, f32(0), q) > f32(thresh)


def ballot(pred):
    return np.uint64(np.packbits(pred, bitorder="little").view("<u4")[0])


def build_edges(hits, valid, cluster, warps, rng):
    """Step 1 for one image, ``cluster`` CTAs of ``warps`` warps: CTA 0's
    words (words, K) uint64, word e of box j at [e, j] (bit r: box 64e + r,
    before j, suppresses j), and the (CTA, warp) that built each box's
    words (-1: none)."""
    k = len(valid)
    words = -(-k // 64)
    edges = rng.randint(-2**62, 2**62, (words, k), dtype=np.int64).view(
        np.uint64)
    built_by = np.full(k, -1)
    lanes = np.arange(32)
    for rank in range(cluster):
        for warp in range(warps):
            for j in range(warp * cluster + rank, k, warps * cluster):
                if not valid[j]:
                    continue
                assert built_by[j] == -1
                built_by[j] = rank * warps + warp
                own = j >> 6
                for e in range(own):
                    i = 64 * e + lanes
                    edges[e, j] = (ballot(hits[j, i + 32]) << np.uint64(32)
                                   | ballot(hits[j, i]))
                i = 64 * own + lanes
                lo = ballot((i < j) & hits[j, np.minimum(i, j)])
                hi = np.uint64(0)
                if 64 * own + 32 < j:
                    hi = ballot((i + 32 < j) & hits[j, np.minimum(i + 32, j)])
                edges[own, j] = hi << np.uint64(32) | lo
    return edges, built_by


def ballot64(lo, hi):
    return ballot(hi) << np.uint64(32) | ballot(lo)


def sweep(edges, valid):
    """Step 2 for one image: keep (K,) bool and the fixed point's rounds a
    tile."""
    words, k = edges.shape
    bits = np.zeros(64 * words, bool)
    bits[:k] = valid
    lanes = np.arange(32)
    kept_words, rounds = [], []
    for w in range(words):
        ja = np.minimum(64 * w + lanes, k - 1)
        jb = np.minimum(64 * w + 32 + lanes, k - 1)
        hit_a = np.zeros(32, np.uint64)
        hit_b = np.zeros(32, np.uint64)
        for e in range(w):
            hit_a |= edges[e, ja] & kept_words[e]
            hit_b |= edges[e, jb] & kept_words[e]
        undecided = ballot64(bits[64 * w + lanes] & (hit_a == 0),
                             bits[64 * w + 32 + lanes] & (hit_b == 0))
        ea, eb = edges[w, ja], edges[w, jb]
        kept, n = np.uint64(0), 0
        while undecided:
            ua = (undecided >> LANES) & ONE == ONE
            ub = (undecided >> (LANES + np.uint64(32))) & ONE == ONE
            reach = kept | undecided
            gone = ballot64(ua & (ea & kept != 0), ub & (eb & kept != 0))
            stays = ballot64(ua & (ea & reach == 0), ub & (eb & reach == 0))
            kept |= stays
            undecided &= ~(gone | stays)
            n += 1
        kept_words.append(kept)
        rounds.append(n)
    j = np.arange(k)
    keep = (np.array(kept_words)[j >> 6] >> (j & 63).astype(np.uint64)) & ONE
    return keep == ONE, rounds


def model_keep(boxes, valid, thresh, seed=0):
    """The kernel's keep mask (B, K) by the model, at the launch shape of
    this batch, and its rounds per image and tile."""
    rng = np.random.RandomState(seed)
    cluster, threads = knms.launch_shape(*valid.shape)
    out, rounds = [], []
    for bx, v in zip(boxes, valid):
        edges, _ = build_edges(hits_matrix(bx, thresh), v, cluster,
                               threads // 32, rng)
        keep, n = sweep(edges, v)
        out.append(keep)
        rounds.append(n)
    return np.stack(out), rounds


def reference(boxes, valid):
    return knms.greedy_keep_reference(torch.from_numpy(boxes),
                                      torch.from_numpy(valid), 0.5).numpy()


def pallas(boxes, valid):
    fn = jax.jit(jax.vmap(lambda b, v: greedy_keep_pallas(
        b, v, 0.5, interpret=True)))
    return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(valid)))


@pytest.mark.parametrize("k", KS)
def test_model_matches_reference_and_pallas(k):
    """Every set at this K, one image each: model == plain version; and ==
    the Pallas kernel on every set whose pairs sit off the threshold, plus
    integer pairs at exactly 0.5."""
    cases = {name: nms_set(name, 1, k, seed=k) for name in NMS_SETS}
    boxes, _, valid = threshold_case(np.random.RandomState(k), 1, k, 1.0)
    cases["threshold_integer"] = boxes, valid
    for name, (boxes, valid) in cases.items():
        got, _ = model_keep(boxes, valid, 0.5, seed=k)
        np.testing.assert_array_equal(got, reference(boxes, valid),
                                      err_msg=f"{name} K={k}")
    off = [n for n in cases if n != "threshold"]
    boxes = np.concatenate([cases[n][0] for n in off])
    valid = np.concatenate([cases[n][1] for n in off])
    want = pallas(boxes, valid)
    for i, name in enumerate(off):
        np.testing.assert_array_equal(reference(*cases[name])[0], want[i],
                                      err_msg=f"{name} K={k}")


@pytest.mark.parametrize("cluster,warps", [(1, 16), (2, 16), (4, 16),
                                           (8, 16), (1, 32), (8, 32)])
def test_every_valid_box_built_once(cluster, warps):
    """Across the cluster's CTAs and warps each valid box's words are built
    once, by warp (j / cluster) % warps of CTA j % cluster, and no invalid
    box's are; the mask does not depend on the launch shape."""
    boxes, valid = nms_set("random", 1, 1000, seed=cluster)
    hits = hits_matrix(boxes[0], 0.5)
    edges, built_by = build_edges(hits, valid[0], cluster, warps,
                                  np.random.RandomState(0))
    i = np.arange(1000)
    want = np.where(valid[0], i % cluster * warps + i // cluster % warps, -1)
    np.testing.assert_array_equal(built_by, want)
    keep, _ = sweep(edges, valid[0])
    np.testing.assert_array_equal(keep, reference(boxes, valid)[0])


def test_unwritten_words_do_not_matter():
    """Words of invalid boxes and past a box's own tile are never stored;
    the sweep gives the same mask whatever they hold."""
    boxes, valid = nms_set("interleaved_invalid", 1, 300, seed=1)
    hits = hits_matrix(boxes[0], 0.5)
    masks = [sweep(build_edges(hits, valid[0], 4, 16,
                               np.random.RandomState(s))[0], valid[0])[0]
             for s in range(3)]
    for m in masks[1:]:
        np.testing.assert_array_equal(m, masks[0])


def test_fixed_point_rounds():
    """The sweep's chain is the depth of suppression, not K: one round a
    tile when nothing overlaps, two when one box suppresses the rest (the
    tiles after it have no candidate left), and one a box along a chain of
    suppressions."""
    k = 256
    _, rounds = model_keep(*nms_set("disjoint", 1, k), 0.5)
    assert rounds == [[1, 1, 1, 1]]
    _, rounds = model_keep(*nms_set("identical", 1, k), 0.5)
    assert rounds == [[2, 0, 0, 0]]
    keep, rounds = model_keep(*nms_set("chain", 1, k), 0.5)
    assert keep[0].tolist() == [i % 2 == 0 for i in range(k)]
    assert rounds == [[64, 64, 64, 64]]
    _, rounds = model_keep(*nms_set("all_invalid", 1, k), 0.5)
    assert rounds == [[0, 0, 0, 0]]


@pytest.mark.parametrize("b,k,want", [
    (8, 512, (8, 1024)), (8, 256, (4, 1024)), (8, 1024, (8, 1024)),
    (1, 1024, (8, 1024)), (8, 100, (2, 1024)), (8, 65, (2, 1024)),
    (8, 64, (1, 1024)), (1, 1, (1, 1024)), (16, 512, (8, 1024)),
    (64, 512, (4, 512)), (128, 512, (2, 512)), (256, 256, (1, 512))])
def test_launch_shape(b, k, want):
    """Up to 8 CTAs an image, at least 64 boxes each, at most two CTAs per
    SM of the H100 over the grid; 1024 threads where the grid fits the card
    once, else 512."""
    assert knms.launch_shape(b, k) == want
