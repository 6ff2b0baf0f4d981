"""The port's on-device data functions against the JAX package's, on the
CPU: ``sample_patches`` and ``synthetic_batch`` with the random draws given.

JAX draws from six (patches: seven) sub-keys of its key; the test makes the
same draws with jax.random and hands them to the port. Bars: boxes,
landmarks, validity and flips identical (every float operation of the
geometry is repeated in the same order); the cropped patches within 1e-5
(two float32 products per patch, summed in another order); synthetic images
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import LabelCfg as JaxLabelCfg
from densebox_tpu.data.patches import sample_patches as jax_sample_patches
from densebox_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from densebox_tpu_torch.config import LabelCfg
from densebox_tpu_torch.data import sample_patches, synthetic_batch
from densebox_tpu_torch.infer.resize import weight_matrices

PERM = (1, 0, 2, 4, 3)


def patch_draws(key, b, k, cfg, max_translate_frac=0.25):
    """The draws ``densebox_tpu.data.patches.sample_patches`` makes from
    ``key``, as the port's ``draws``."""
    k_anchor, k_scale, k_trans, k_neg, k_negpos, k_flip = jax.random.split(key, 6)
    lo, hi = cfg.scale_band
    d = {"anchor": jax.random.uniform(k_anchor, (b, k)),
         "scale": jax.random.uniform(k_scale, (b,), minval=lo, maxval=hi),
         "trans": jax.random.uniform(k_trans, (b, 2),
                                     minval=-max_translate_frac,
                                     maxval=max_translate_frac),
         "neg_size": jax.random.uniform(k_neg, (b,), minval=0.5, maxval=2.0),
         "neg_pos": jax.random.uniform(k_negpos, (b, 2)),
         "neg": jax.random.uniform(k_flip, (b,)),
         "flip": jax.random.uniform(jax.random.fold_in(k_flip, 1), (b,))}
    return {n: torch.from_numpy(np.array(v)) for n, v in d.items()}


def _canvas_batch(seed, b, k, num_lm, hw=(96, 128)):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, *hw, 3).astype(np.float32)
    ctr = rng.uniform(20, 76, (b, k, 2))
    h = rng.uniform(12, 40, (b, k))
    w = h * rng.uniform(0.7, 1.3, (b, k))
    boxes = np.stack([ctr[..., 0] - w / 2, ctr[..., 1] - h / 2,
                      ctr[..., 0] + w / 2, ctr[..., 1] + h / 2],
                     -1).astype(np.float32)
    valid = rng.rand(b, k) > 0.3
    valid[0] = False                      # an image without boxes
    lms = lmv = None
    if num_lm:
        lms = (ctr[:, :, None, :] + rng.uniform(-8, 8, (b, k, num_lm, 2))
               ).astype(np.float32)
        lmv = rng.rand(b, k, num_lm) > 0.2
    return img, boxes, valid, lms, lmv


@pytest.mark.parametrize("num_lm,perm,hflip", [(0, None, True), (5, PERM, True),
                                               (3, None, True), (5, PERM, False)],
                         ids=["det", "lm5_perm", "lm3", "lm5_noflip"])
def test_sample_patches_matches_jax(num_lm, perm, hflip):
    kw = dict(patch_size=64, std_height_px=20.0, lm_flip_perm=perm)
    b, k = 6, 4
    img, boxes, valid, lms, lmv = _canvas_batch(num_lm, b, k, num_lm)
    key = jax.random.key(4)
    want = jax_sample_patches(
        key, jnp.asarray(img), jnp.asarray(boxes), jnp.asarray(valid),
        JaxLabelCfg(**kw), hflip=hflip,
        landmarks=None if lms is None else jnp.asarray(lms),
        lm_valid=None if lmv is None else jnp.asarray(lmv))
    want = {n: np.asarray(v) for n, v in want.items()}
    t = [None if a is None else torch.from_numpy(a)
         for a in (img, boxes, valid, lms, lmv)]
    got = sample_patches(None, t[0], t[1], t[2], LabelCfg(**kw), hflip=hflip,
                         landmarks=t[3], lm_valid=t[4],
                         draws=patch_draws(key, b, k, LabelCfg(**kw)))
    got = {n: v.numpy() for n, v in got.items()}
    assert set(got) == set(want)
    assert got["image"].shape == (b, 64, 64, 3)
    np.testing.assert_allclose(got["image"], want["image"], atol=1e-5, rtol=0)
    for name in set(want) - {"image"}:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["box_valid"].any() and not want["box_valid"][0].any()
    if hflip:
        assert want["flipped"].any() and not want["flipped"].all()


def test_weight_matrices_match_jax_scale_and_translate():
    """Down- and upscaling windows, inside and partly outside the canvas:
    the weights equal ``compute_weight_mat`` to 1e-6 (a normalised triangle
    filter: one division and one sum per weight)."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    scale = np.float32([0.4, 1.0, 2.5, 0.77])
    trans = np.float32([-3.0, 0.0, 10.5, -40.0])
    got = weight_matrices(48, 20, torch.from_numpy(scale),
                          torch.from_numpy(trans)).numpy()
    for i in range(4):
        want = compute_weight_mat(48, 20, jnp.float32(scale[i]),
                                  jnp.float32(trans[i]),
                                  _fill_triangle_kernel, True)
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-6, rtol=0)


def test_sample_patches_own_draws():
    """From a generator: shapes, ranges, determinism per seed, and the bf16
    crop."""
    cfg = LabelCfg(patch_size=64, std_height_px=20.0, lm_flip_perm=PERM)
    img, boxes, valid, lms, lmv = (torch.from_numpy(a) for a in
                                   _canvas_batch(1, 6, 4, 5))

    def run(seed, **kw):
        return sample_patches(torch.Generator().manual_seed(seed), img, boxes,
                              valid, cfg, landmarks=lms, lm_valid=lmv, **kw)
    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["boxes"], c["boxes"])
    assert a["image"].shape == (6, 64, 64, 3) and a["image"].dtype == torch.float32
    assert a["boxes"].shape == (6, 4, 4) and a["landmarks"].shape == (6, 4, 5, 2)
    assert a["lm_valid"].shape == (6, 4, 5) and a["flipped"].shape == (6,)
    assert float(a["image"].min()) >= -1e-6 and float(a["image"].max()) <= 1 + 1e-6
    assert not (a["lm_valid"] & ~a["box_valid"][..., None]).any()
    half = run(0, crop_dtype=torch.bfloat16)
    assert half["image"].dtype == torch.bfloat16
    assert float((half["image"].float() - a["image"]).abs().max()) < 0.05
    with pytest.raises(ValueError, match="unknown draws"):
        run(0, draws={"zoom": None})
    with pytest.raises(ValueError, match="no generator"):
        sample_patches(None, img, boxes, valid, cfg)


def synthetic_draws(key, b, k, cfg):
    """The draws ``densebox_tpu.data.synthetic.synthetic_batch`` makes from
    ``key``, as the port's ``draws``."""
    ps, std_h = cfg.patch_size, cfg.std_height_px
    k_n, k_c, k_h, k_a, k_noise, k_amp = jax.random.split(key, 6)
    d = {"n_boxes": jax.random.randint(k_n, (b,), 1, k + 1),
         "ctr": jax.random.uniform(k_c, (b, k, 2), minval=0.25 * ps,
                                   maxval=0.75 * ps),
         "hgt": jax.random.uniform(k_h, (b, k), minval=0.85 * std_h,
                                   maxval=1.2 * std_h),
         "asp": jax.random.uniform(k_a, (b, k), minval=0.8, maxval=1.25),
         "amp": jax.random.uniform(k_amp, (b, 1, 1), minval=0.7, maxval=1.0),
         "noise": jax.random.normal(k_noise, (b, ps, ps, 3))}
    return {n: torch.from_numpy(np.array(v)) for n, v in d.items()}


@pytest.mark.parametrize("num_lm", [0, 4, 5])
def test_synthetic_batch_matches_jax(num_lm):
    kw = dict(patch_size=64, std_height_px=20.0)
    key = jax.random.key(2)
    want = jax_synthetic_batch(key, 3, JaxLabelCfg(**kw), max_boxes=4,
                               num_landmarks=num_lm)
    got = synthetic_batch(None, 3, LabelCfg(**kw), max_boxes=4,
                          num_landmarks=num_lm, device="cpu",
                          draws=synthetic_draws(key, 3, 4, LabelCfg(**kw)))
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_synthetic_batch_own_draws():
    cfg = LabelCfg(patch_size=64, std_height_px=20.0)

    def run(seed, **kw):
        return synthetic_batch(torch.Generator().manual_seed(seed), 8, cfg,
                               max_boxes=4, num_landmarks=5, device="cpu", **kw)
    a, b, c = run(0), run(0), run(1)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["boxes"], c["boxes"])
    n = a["box_valid"].sum(1)
    assert int(n.min()) >= 1 and int(n.max()) <= 4 and len(set(n.tolist())) > 1
    h = (a["boxes"][..., 3] - a["boxes"][..., 1])
    assert float(h.min()) >= 0.85 * 20 - 1e-4 and float(h.max()) <= 1.2 * 20 + 1e-4
    assert a["image"].shape == (8, 64, 64, 3)
    assert a["landmarks"].shape == (8, 4, 5, 2) and a["lm_valid"].shape == (8, 4, 5)
    assert torch.equal(a["landmarks"][:, :, 4], a["landmarks"][:, :, 0])
    assert run(0, image_dtype=torch.bfloat16)["image"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown draws"):
        run(0, draws={"colour": None})
