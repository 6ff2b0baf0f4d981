"""Served results independent of the batch slot, on the card.

One image in each slot of a B=8 batch of other images gives bit-identical
maps at every pyramid level, and each image's detections equal a detect of
it alone in slot 0 of a zero batch: paper bf16 (``kitti_vehicle()``, 4
scales), ``malf_face()`` bf16 (5 scales) and ``kitti_vehicle()`` f32, at
full width on a 480 x 640 canvas (where cuDNN's bf16 kernels for the
512-channel convs at the 0.7071 and 0.3536 levels depend on the slot, and
``models/densebox.py:split_by_image`` runs them one image a call).

These tests need a CUDA card (marker ``gpu``) and skip without one. No jax
is imported, so on the machine with the card they run as

    python -m pytest --noconftest -q tests/test_torch_slot_card.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from densebox_tpu_torch import kitti_vehicle, malf_face
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.infer.detector import pyramid_maps
from densebox_tpu_torch.models import DenseBox, init_params

BF16 = dict(compute_dtype="bfloat16", param_dtype="bfloat16")
CELLS = {"paper_bf16": (kitti_vehicle, BF16), "malf_bf16": (malf_face, BF16),
         "paper_f32": (kitti_vehicle, {})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (cuDNN's kernels are the subject)")
    return torch.device("cuda")


def _canvas(n=8, hw=(480, 640), seed=3):
    rng = np.random.RandomState(seed)
    x = np.zeros((n,) + hw + (3,), np.float32)
    for i in range(n):
        h, w = hw[0] - 40 * (i % 3), hw[1] - 64 * (i % 4)
        x[i, :h, :w] = rng.rand(h, w, 3) * 0.3
        x[i, 40:200, 64:300] += 0.6
    return torch.from_numpy(x)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_slot_gives_an_image_the_same_maps(cuda, cell):
    preset, kw = CELLS[cell]
    cfg = preset()
    model_cfg = dataclasses.replace(cfg.model, **kw)
    model = DenseBox(model_cfg, device=cuda)
    model.load_state_dict(init_params(model_cfg,
                                      torch.Generator().manual_seed(0)))
    model.eval()
    x = _canvas().to(cuda)
    n = x.shape[0]
    with torch.inference_mode():
        base = pyramid_maps(model, x, cfg.infer)
        for s in range(1, n):
            rolled = pyramid_maps(model, torch.roll(x, s, 0), cfg.infer)
            for lvl, ((a, _), (b, _)) in enumerate(zip(base, rolled)):
                for k in a:
                    assert torch.equal(torch.roll(b[k], -s, 0), a[k]), \
                        (cell, s, lvl, k)
        infer = dataclasses.replace(cfg.infer, score_thresh=float(
            torch.quantile(base[-1][0]["score"].flatten()[::7].float(),
                           0.99)))
        full = detect_batch(model, x, infer, cfg.label)
        for i in range(n):
            alone = torch.zeros_like(x)
            alone[0] = x[i]
            one = detect_batch(model, alone, infer, cfg.label)
            v = full["valid"][i]
            assert torch.equal(v, one["valid"][0]), (cell, i)
            for k in full:
                assert torch.equal(full[k][i][v], one[k][0][v]), (cell, i, k)
