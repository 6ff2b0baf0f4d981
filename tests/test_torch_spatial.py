"""Spatial (halo-exchange) parallelism in the port: ``spatial_forward`` and
``SpatialDenseBox`` over 2 and 4 CPU processes (gloo), against the port's
local forward and detect, and against the JAX package's
``spatial_forward`` on a 2-device CPU mesh.

Bars (JAX's ``tests/test_spatial.py``): head maps within 2e-5 of the local
forward; detections through ``detect_batch``: the same valid slots, boxes
within 1e-3. Against JAX's sharded forward: 1e-4 (the port's bar for f32
maps against JAX, ROADMAP.md: another framework's convolutions sum in
another order).

Heights are chosen so that some levels do not split evenly (72 rows = 9
blocks of 8 over 4 ranks; the 0.7071 level of a 96-row image, 72 rows):
shards are whole blocks, the first ranks one block more. Each world size
is one spawn that runs every case; the tests read its results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import ModelCfg as JaxModelCfg
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.parallel.mesh import make_mesh as jax_make_mesh
from densebox_tpu.parallel.spatial import \
    _shard_upsample_matrices as jax_shard_matrices
from densebox_tpu.parallel.spatial import spatial_forward as jax_spatial
from densebox_tpu_torch.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import DenseBox, from_flax, init_params
from densebox_tpu_torch.parallel.multihost import run_processes
from densebox_tpu_torch.parallel.spatial import (shard_rows,
                                                 shard_upsample_matrix)
from torch_parallel_workers import spatial_rank

STEMS = {"conv": 4, "s2d": 3, "s2d4": 3}          # stem -> trunk depth
HEADS = {"det": (0, False), "lm3_refine": (3, True)}
FORWARD = [(s, h) for s in STEMS for h in HEADS]
WORLDS = (2, 4)
INFER = InferCfg(scales=(0.5, 0.7071, 1.0, 1.4142), score_thresh=-1e9,
                 topk_per_scale=32, max_dets=8)


def _cfg(stem, head):
    lm, refine = HEADS[head]
    return ModelCfg(stem=stem, trunk_depth=STEMS[stem], width_mult=0.125,
                    num_landmarks=lm, use_refine=refine)


def _model(cfg, sd):
    m = DenseBox(cfg, device="cpu")
    m.load_state_dict(sd)
    return m.eval()


@pytest.fixture(scope="module")
def cases():
    """Every forward case (cfg, weights, images), the JAX case (its own
    Flax weights, converted) and the detect case."""
    g = torch.Generator().manual_seed(0)
    fwd = {}
    for stem, head in FORWARD:
        cfg = _cfg(stem, head)
        fwd[(stem, head)] = (cfg, init_params(cfg, g),
                             torch.rand((2, 72, 48, 3), generator=g))
    fwd["bad_height"] = (_cfg("conv", "det"), fwd[("conv", "det")][1],
                         torch.rand((1, 60, 48, 3), generator=g))
    jcfg = JaxModelCfg(num_landmarks=3, use_refine=True, width_mult=0.125)
    x = np.random.RandomState(1).rand(2, 64, 48, 3).astype(np.float32)
    jparams = JaxDenseBox(jcfg).init(jax.random.key(1), jnp.asarray(x))
    cfg = _cfg("conv", "lm3_refine")
    fwd["jax"] = (cfg, from_flax(jax.tree.map(np.asarray, jparams), cfg),
                  torch.from_numpy(x))
    dcfg = _cfg("conv", "det")
    dsd = init_params(dcfg, g)
    dsd["loc.loc_conv2.bias"] += 1.0    # boxes of a few pixels, not one
    det = {"det": (dcfg, dsd, torch.rand((2, 96, 64, 3), generator=g),
                   INFER, LabelCfg())}
    return fwd, det, jparams, jcfg, x


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """world size -> rank -> what ``spatial_rank`` saved."""
    fwd, det, *_ = cases
    out = {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"spatial{n}")
        run_processes(spatial_rank, n, (n, str(d / "pg"), str(d), fwd, det),
                      timeout=120)
        out[n] = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    return out


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("stem,head", FORWARD)
def test_spatial_forward_matches_local(cases, runs, stem, head, n):
    cfg, sd, x = cases[0][(stem, head)]
    with torch.no_grad():
        want = _model(cfg, sd)(x)
    for got in runs[n]:
        maps = got["maps"][(stem, head)]
        assert set(maps) == set(want)
        for k in want:
            assert maps[k].shape == want[k].shape
            np.testing.assert_allclose(maps[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_rejects_bad_height(runs, n):
    for got in runs[n]:
        assert "H=60 must be a multiple of 8" in got["errors"]["bad_height"]
    with pytest.raises(ValueError):
        shard_rows(24, 4, 8)             # 3 blocks for 4 ranks
    assert shard_rows(72, 4, 8) == [(0, 24), (24, 16), (40, 16), (56, 16)]
    assert shard_rows(64, 2, 8) == [(0, 32), (32, 32)]


def test_shard_upsample_matrices_match_jax():
    """Even shards: the per-shard matrices are JAX's
    ``_shard_upsample_matrices``."""
    for h, n in ((8, 2), (12, 4), (6, 3)):
        want = jax_shard_matrices(h, n)
        hl = h // n
        for s in range(n):
            np.testing.assert_array_equal(
                shard_upsample_matrix(h, s * hl, hl), want[s])


@pytest.mark.parametrize("n", WORLDS)
def test_spatial_detect_keeps_the_same_boxes(cases, runs, n):
    cfg, sd, x, icfg, lcfg = cases[1]["det"]
    with torch.inference_mode():
        want = detect_batch(_model(cfg, sd), x, icfg, lcfg)
    assert int(want["valid"].sum()) > 4
    for got in runs[n]:
        dets = got["dets"]["det"]
        assert torch.equal(dets["valid"], want["valid"])
        np.testing.assert_allclose(dets["boxes"].numpy(),
                                   want["boxes"].numpy(), rtol=0, atol=1e-3)


def test_spatial_forward_matches_jax(cases, runs):
    """The port's 2-rank spatial forward against JAX's ``spatial_forward``
    on a 2-device CPU mesh, on the same (Flax-initialised) weights."""
    _, _, jparams, jcfg, x = cases
    mesh = jax_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    want = jax_spatial(jparams, jnp.asarray(x), jcfg, mesh)
    got = runs[2][0]["maps"]["jax"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)
