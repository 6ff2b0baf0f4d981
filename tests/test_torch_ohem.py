"""The port's OHEM selection and loss against the JAX package's, on the CPU.

The port's ``ohem_select`` (its plain version here: CPU tensors) gets the
uniforms the JAX kernel wrapper draws from its key (per-sample split, then
``uniform``), made in the test. Bars: masks identical to the Pallas kernel
in interpret mode on every case (counts are integers, the bisection has no
sum of products to contract), identical to the sort twin where values are
distinct; loss and metrics within 1e-6 relative of ``densebox_loss`` with
``LossCfg(backend="pallas")`` (float32 sums in another order), gradients
within 1e-6 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import LossCfg as JaxLossCfg
from densebox_tpu.ops import ohem as jax_ohem
from densebox_tpu.ops.pallas.ohem import _count_threshold as jax_threshold
from densebox_tpu.ops.pallas.ohem import ohem_mask_pallas
from densebox_tpu_torch.config import LossCfg
from densebox_tpu_torch.ops.kernels.ohem import (BISECT_ITERS, LIST_CAP,
                                                 _count_threshold,
                                                 ohem_select,
                                                 ohem_select_reference,
                                                 reference_bisections,
                                                 staged_threshold)
from densebox_tpu_torch.ops.ohem import densebox_loss, ohem_mask
from test_torch_kernels import ohem_case


def kernel_uniforms(key, b, p):
    """The (B, P) uniforms ``ohem_mask_pallas`` (and the vmapped sort twin)
    draws from ``key``."""
    keys = jax.random.split(key, b)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (p,)))(keys))


def _port_mask(sq, pos, ign, rnd, cfg):
    t = [torch.from_numpy(np.array(a)) for a in (sq, pos, ign, rnd)]
    return ohem_select(*t, cfg.neg_pos_ratio, cfg.hard_frac,
                       cfg.min_neg).numpy()


@pytest.mark.parametrize("kind", ["random", "tied", "no_pos", "short",
                                  "levels"])
@pytest.mark.parametrize("cfg_kw", [{}, dict(neg_pos_ratio=2.5, hard_frac=0.3,
                                             min_neg=7)], ids=["default", "odd"])
def test_mask_identical_to_pallas_kernel(kind, cfg_kw):
    b, p = 3, 400
    sq, pos, ign, _ = ohem_case(11, b, p, kind)
    key = jax.random.key(5)
    want = np.asarray(ohem_mask_pallas(jnp.asarray(sq), jnp.asarray(pos),
                                       jnp.asarray(ign), key,
                                       JaxLossCfg(**cfg_kw)))
    got = _port_mask(sq, pos, ign, kernel_uniforms(key, b, p),
                     LossCfg(**cfg_kw))
    assert got.dtype == np.bool_ and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    assert got[pos].all() and not got[ign].any()


def test_mask_identical_to_sort_twin_on_distinct_values():
    b, p = 4, 400
    sq, pos, ign, _ = ohem_case(3, b, p, "random")
    assert len(np.unique(sq)) == sq.size
    key = jax.random.key(9)
    cfg = JaxLossCfg()
    want = np.asarray(jax.vmap(
        lambda s, ps, i, k: jax_ohem.ohem_mask(s, ps, i, k, cfg))(
            jnp.asarray(sq), jnp.asarray(pos), jnp.asarray(ign),
            jax.random.split(key, b)))
    rnd = kernel_uniforms(key, b, p)
    got = _port_mask(sq, pos, ign, rnd, LossCfg())
    np.testing.assert_array_equal(got, want)
    one = ohem_mask(*(torch.from_numpy(a[1]) for a in (sq, pos, ign, rnd)),
                    LossCfg())
    np.testing.assert_array_equal(one.numpy(), want[1])


def test_mask_counts_and_hardest_half():
    """The invariants of tests/test_ohem.py, on the port."""
    sq, pos, ign, rnd = ohem_case(0, 2, 400, "random")
    mask = _port_mask(sq, pos, ign, rnd, LossCfg())
    for i in range(2):
        npos = int(pos[i].sum())
        assert mask[i].sum() - npos == npos
        cand = np.where(~pos[i] & ~ign[i], sq[i], -np.inf)
        assert mask[i][np.argsort(-cand)[:npos // 2]].all()
    none = _port_mask(sq, np.zeros_like(pos), np.zeros_like(ign), rnd,
                      LossCfg(min_neg=16))
    assert (none.sum(1) == 16).all()


def test_quota_rounds_half_to_even():
    """ratio 1.1 * 15 positives is 16.5 in float32: the quota is 16 (round
    half to even, as jnp.round), not 17. The port and the JAX kernel agree."""
    p = 256
    pos = np.zeros((1, p), bool)
    pos[0, :15] = True
    sq = np.linspace(0, 1, p, dtype=np.float32)[None]
    ign = np.zeros_like(pos)
    key = jax.random.key(0)
    cfg = dict(neg_pos_ratio=1.1)
    want = np.asarray(ohem_mask_pallas(jnp.asarray(sq), jnp.asarray(pos),
                                       jnp.asarray(ign), key,
                                       JaxLossCfg(**cfg)))
    got = _port_mask(sq, pos, ign, kernel_uniforms(key, 1, p), LossCfg(**cfg))
    np.testing.assert_array_equal(got, want)
    assert got.sum() - 15 == 16


def _loss_inputs(seed, b, m, num_lm, refined):
    rng = np.random.RandomState(seed)
    score_gt = (rng.rand(b, m, m, 1) > 0.9).astype(np.float32)
    ignore = ((rng.rand(b, m, m, 1) > 0.9) & (score_gt == 0)).astype(np.float32)
    gts = {"score": score_gt, "loc_mask": score_gt, "ignore": ignore,
           "loc": rng.randn(b, m, m, 4).astype(np.float32) * score_gt}
    preds = {"score": rng.randn(b, m, m, 1).astype(np.float32),
             "loc": rng.randn(b, m, m, 4).astype(np.float32)}
    if num_lm:
        gts["lm"] = (rng.rand(b, m, m, num_lm) > 0.95).astype(np.float32)
        preds["lm"] = rng.randn(b, m, m, num_lm).astype(np.float32)
    if refined:
        preds["refined"] = rng.randn(b, m, m, 1).astype(np.float32)
    return preds, gts


@pytest.mark.parametrize("num_lm,refined", [(0, False), (3, False), (3, True)],
                         ids=["det", "lm", "lm_refined"])
def test_loss_matches_jax(num_lm, refined):
    b, m = 3, 16
    preds, gts = _loss_inputs(4, b, m, num_lm, refined)
    key = jax.random.key(2)
    jcfg = JaxLossCfg(backend="pallas")
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    jg = {k: jnp.asarray(v) for k, v in gts.items()}
    (want, want_met), want_grad = jax.value_and_grad(
        lambda p_: jax_ohem.densebox_loss(p_, jg, key, jcfg), has_aux=True)(jp)

    k_cls, k_ref = jax.random.split(key)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    tg = {k: torch.from_numpy(v) for k, v in gts.items()}
    got, got_met = densebox_loss(
        tp, tg, torch.from_numpy(kernel_uniforms(k_cls, b, m * m)), LossCfg(),
        torch.from_numpy(kernel_uniforms(k_ref, b, m * m)) if refined else None)
    got.backward()
    assert set(got_met) == set(want_met)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for k in want_met:
        np.testing.assert_allclose(float(got_met[k]), float(want_met[k]),
                                   rtol=1e-6, err_msg=k)
    for k in preds:
        w = np.asarray(want_grad[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_loss_needs_uniforms_for_the_refined_term():
    preds, gts = _loss_inputs(0, 2, 8, 0, True)
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    tg = {k: torch.from_numpy(v) for k, v in gts.items()}
    with pytest.raises(ValueError, match="rnd_refined"):
        densebox_loss(tp, tg, torch.rand(2, 64), LossCfg())
    with pytest.raises(ValueError, match="loc prediction"):
        densebox_loss({**tp, "loc": tp["loc"][..., :3]}, tg,
                      torch.rand(2, 64), LossCfg())


def test_reference_is_what_a_cpu_tensor_runs():
    args = [torch.from_numpy(a) for a in ohem_case(1, 2, 300, "levels")]
    assert torch.equal(ohem_select(*args, 1.0, 0.5, 16),
                       ohem_select_reference(*args, 1.0, 0.5, 16))


def _same_bits(a, b):
    return np.float32(a).tobytes() == np.float32(b).tobytes()


def _training_case(kind, b=2, p=3600):
    if kind != "forward":
        return ohem_case(7, b, p, kind)
    rng = np.random.RandomState(21)     # squared errors of a score map
    pos = rng.rand(b, p) < 0.03
    ign = (rng.rand(b, p) < 0.05) & ~pos
    sq = ((rng.randn(b, p) * 0.3 - pos) ** 2).astype(np.float32)
    return sq, pos, ign, rng.rand(b, p).astype(np.float32)


KINDS = ["random", "tied", "no_pos", "short", "levels", "forward"]


def _bisections(kind, b=2):
    """The three bisections the plain version takes on a training case."""
    _, calls = reference_bisections(
        *(torch.from_numpy(a) for a in _training_case(kind, b)), 1.0, 0.5, 16)
    assert len(calls) == 3
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_reference_thresholds_equal_jax_twin_without_jit(kind):
    """The plain version's three thresholds per sample, at the training P,
    against the TPU kernel's own ``_count_threshold`` run eagerly: the same
    float32, bit for bit (and so the same masks)."""
    with jax.disable_jit():
        for values, cand, n_want, hi in _bisections(kind):
            want = jax_threshold(jnp.asarray(values[:1].numpy()),
                                 jnp.asarray(cand[:1].numpy()),
                                 jnp.int32(int(n_want[0])))
            assert _same_bits(np.asarray(want), hi[0].numpy())


def subtree_threshold(values, cand, n_want, levels):
    """A bisection that counts a whole subtree per round, in numpy float32:
    lo and hi move by mid = 0.5 * (lo + hi), so the 2^levels - 1 mids of the
    next ``levels`` levels are known before any count arrives; they are
    counted together and the levels walked with the counts in hand. A set of
    at most ``n_want`` elements takes no count at all. Returns (hi, rounds).
    (The CUDA kernel counts one level a round: on an H100 the wider rounds
    were slower. This holds that they would be exact.)"""
    f32 = np.float32
    v = np.asarray(values, f32)[np.asarray(cand, bool)]

    def midpoint(lo, hi):
        return f32(f32(0.5) * f32(lo + hi))

    lo = f32(-1.0)
    hi = f32(max(f32(v.max()) if v.size else f32(0.0), f32(0.0)) + f32(1.0))
    if v.size <= n_want:
        for _ in range(BISECT_ITERS):
            hi = midpoint(lo, hi)
        return hi, 0
    left, rounds = BISECT_ITERS, 0
    while left > 0:
        span, mids, counts = {1: (lo, hi)}, {}, {}
        for i in range(1, 2 ** levels):                  # heap order
            mids[i] = midpoint(*span[i])
            counts[i] = int((v > mids[i]).sum())
            span[2 * i] = (span[i][0], mids[i])          # count <= quota
            span[2 * i + 1] = (mids[i], span[i][1])      # count > quota
        node = 1
        for _ in range(min(levels, left)):
            if counts[node] > n_want:
                lo, node = mids[node], 2 * node + 1
            else:
                hi, node = mids[node], 2 * node
        left -= min(levels, left)
        rounds += 1
    return hi, rounds


@pytest.mark.parametrize("kind", KINDS)
def test_staged_threshold_equals_the_literal_bisection(kind):
    """The CUDA kernel's schedule (no count where the set cannot exceed the
    quota, one level a block-wide round, one warp finishing on the elements
    left inside the interval) gives the hi of the 40 literal steps bit for
    bit, in all three bisections of a sample, at the training P (more
    candidates than the warp's list holds)."""
    staged = 0
    for values, cand, n_want, hi in _bisections(kind):
        for i in range(len(hi)):
            got, rounds, warp_levels = staged_threshold(
                values[i].numpy(), cand[i].numpy(), int(n_want[i]))
            assert _same_bits(got, hi[i].numpy()), (kind, i)
            # counted rounds, levels above the maximum (no count) and the
            # warp's levels make up the 40
            assert rounds + warp_levels <= BISECT_ITERS
            staged += rounds > 0 or warp_levels > 0
    if kind != "short":
        assert staged       # the counted path ran, not only the shortcut


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_subtree_bisection_equals_the_literal_bisection(kind, levels):
    """Counting ``levels`` levels per round gives the hi of the 40 literal
    steps bit for bit, in 14 (3 levels) or 20 (2 levels) rounds."""
    counted = 0
    for values, cand, n_want, hi in _bisections(kind):
        for i in range(len(hi)):
            got, rounds = subtree_threshold(
                values[i].numpy(), cand[i].numpy(), int(n_want[i]), levels)
            assert _same_bits(got, hi[i].numpy()), (kind, i)
            assert rounds in (0, -(-BISECT_ITERS // levels))
            counted += rounds
    if kind != "short":
        assert counted


def _edge_sets(size, n_want):
    """Candidate sets of ``size`` elements over values that are distinct,
    all tied, on a grid of thirds, or crowded near zero, each with the
    literal threshold for ``n_want``."""
    p = 3200
    rng = np.random.RandomState(size + 7 * n_want)
    for values in (rng.rand(p).astype(np.float32),
                   np.full(p, 0.25, np.float32),
                   np.round(rng.rand(p) * 3).astype(np.float32) / 3,
                   (rng.rand(p) * 1e-3).astype(np.float32) ** 4):
        cand = np.zeros(p, bool)
        cand[rng.permutation(p)[:size]] = True
        want = _count_threshold(torch.from_numpy(values)[None],
                                torch.from_numpy(cand)[None],
                                torch.tensor([n_want]))[0].numpy()
        yield values, cand, want


EDGE_SIZES = [0, 1, 5, 6, 300, 301, 3000]


@pytest.mark.parametrize("size", EDGE_SIZES)
@pytest.mark.parametrize("n_want", [0, 5, 300])
def test_staged_threshold_edge_sets(size, n_want):
    """Sets of size 0, 1, n_want and n_want + 1, a quota of 0, sets around
    the list's capacity, and values that all tie or tie at the maximum."""
    for values, cand, want in _edge_sets(size, n_want):
        got, rounds, warp_levels = staged_threshold(values, cand, n_want)
        assert _same_bits(got, want)
        if size <= n_want or size == 1:
            assert rounds == warp_levels == 0
        elif size <= LIST_CAP:
            assert (rounds, warp_levels) == (0, 40)


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("size", EDGE_SIZES)
@pytest.mark.parametrize("n_want", [0, 5, 300])
def test_subtree_bisection_edge_sets(size, n_want, levels):
    """The same sets through the subtree rounds: no count at all where the
    set holds no more than the quota."""
    for values, cand, want in _edge_sets(size, n_want):
        got, rounds = subtree_threshold(values, cand, n_want, levels)
        assert _same_bits(got, want)
        assert (rounds == 0) == (size <= n_want)
