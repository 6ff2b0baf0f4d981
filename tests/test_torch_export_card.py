"""The export path on the card: the five custom operators of the detect path
launch their CUDA kernels (and never their plain versions) on CUDA tensors,
and an artifact exported on the card equals the live ``detect_batch`` bit
for bit with the same launches per call.

These tests need a CUDA card (marker ``gpu``) and skip without one. No jax
is imported, so on the machine with the card they run as

    python -m pytest --noconftest -q tests/test_torch_export_card.py
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from densebox_tpu_torch import LabelCfg, ModelCfg, kitti_vehicle
from densebox_tpu_torch.export import (artifact_meta, export_detect_program,
                                       load_exported, save_exported)
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox, init_params,
                                       quantize_densebox)
from densebox_tpu_torch.ops.kernels import neck as kneck
from densebox_tpu_torch.ops.kernels import nms as knms
from densebox_tpu_torch.ops.kernels import qconv as kqconv
from densebox_tpu_torch.ops.kernels import requant as krequant
from densebox_tpu_torch.ops.kernels import window as kwindow
import torch_threads  # noqa: F401  (sets torch's threads)

CANVAS = (96, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _boom(*args, **kwargs):
    raise AssertionError("the plain version ran on a CUDA tensor")


@pytest.mark.gpu
def test_custom_ops_launch_their_kernels(cuda):
    rng = np.random.RandomState(0)
    boxes = np.sort(rng.uniform(0, 100, (2, 64, 4)).astype(np.float32), -1)
    valid = rng.rand(2, 64) > 0.2
    x = torch.from_numpy(rng.randint(-127, 128, (2, 12, 16, 32))
                         .astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (16, 3, 3, 32))
                         .astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 2e-4, 16).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, 16).astype(np.float32))
    acc = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, (2, 12, 16, 16))
                           .astype(np.int32))
    maps = torch.from_numpy(rng.rand(2, 3, 4, 24, 32).astype(np.float32))
    sel = torch.from_numpy(rng.randint(0, 3, (2, 5)).astype(np.int32))
    y0 = torch.from_numpy(rng.randint(0, 16, (2, 5, 4)).astype(np.int32))
    x0 = torch.from_numpy(rng.randint(0, 24, (2, 5, 4)).astype(np.int32))
    f4 = torch.from_numpy(rng.rand(2, 6, 8, 16).astype(np.float32))
    s3 = torch.tensor(0.02)
    cases = [
        (knms, "greedy_keep_reference",
         lambda d: knms.greedy_keep(torch.from_numpy(boxes).to(d),
                                    torch.from_numpy(valid).to(d), 0.5)),
        (kqconv, "qconv_reference",
         lambda d: kqconv.qconv_int8(x.to(d), w.to(d), scale.to(d),
                                     bias.to(d), torch.tensor(2.0).to(d))),
        (krequant, "requant_reference",
         lambda d: krequant.requant_epilogue(acc.to(d), scale.to(d),
                                             bias.to(d), None, relu=False)),
        (kwindow, "gather_windows_reference",
         lambda d: kwindow.gather_windows(maps.to(d), sel.to(d), y0.to(d),
                                          x0.to(d), 8)),
        (kneck, "neck_reference",
         lambda d: kneck.int8_neck(x.to(d), f4.to(d), s3.to(d), s3.to(d)))]
    for mod, reference, run in cases:
        want = run("cpu")
        before = mod.launches
        with mock.patch.object(mod, reference, _boom):
            got = run(cuda)
            torch.cuda.synchronize()
        assert mod.launches == before + 1, mod.__name__
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), \
            mod.__name__


def _launches():
    return {"nms": knms.launches, "qconv": kqconv.launches,
            "requant": krequant.launches, "window": kwindow.launches,
            "neck": kneck.launches}


def _models(dev):
    """An int8 turbo model (every conv on the tensor cores) and a float
    landmark model with refine (the window kernel)."""
    x = torch.from_numpy(np.random.RandomState(1).rand(2, *CANVAS, 3)
                         .astype(np.float32)).to(dev)
    turbo = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.25)
    q = QuantDenseBox(turbo, device=dev)
    q.load_state_dict(quantize_densebox(
        init_params(turbo, torch.Generator().manual_seed(0)), turbo, x))
    lcfg = ModelCfg(width_mult=0.25, num_landmarks=4, use_refine=True)
    sd = init_params(lcfg, torch.Generator().manual_seed(0))
    sd["loc.loc_conv2.bias"] += 1.0
    lm = DenseBox(lcfg, device=dev)
    lm.load_state_dict(sd)
    infer = dataclasses.replace(kitti_vehicle().infer, score_thresh=-1e9,
                                scales=(1.0,), lm_topk=8)
    return x, [(q.eval(), infer, {"nms": 1, "qconv": 14, "requant": 0,
                                  "window": 0, "neck": 1}),
               (lm.eval(), infer, {"nms": 1, "qconv": 0, "requant": 0,
                                   "window": 1, "neck": 0})]


@pytest.mark.gpu
def test_artifact_on_the_card_equals_live(cuda, tmp_path):
    x, cases = _models(cuda)
    label = LabelCfg()
    for i, (model, infer, per_call) in enumerate(cases):
        ep = export_detect_program(model, infer, label, 2, CANVAS)
        path = str(tmp_path / f"{i}.pt2")
        save_exported(path, ep, artifact_meta(model, infer, 2, CANVAS))
        call, meta = load_exported(path)
        assert meta["device"] == str(torch.device(
            "cuda", torch.cuda.current_device()))
        with torch.no_grad():
            want = detect_batch(model, x, infer, label)
        before = _launches()
        kqconv.variant_launches.clear()
        got = call(x)
        torch.cuda.synchronize()
        after = _launches()
        assert {k: after[k] - before[k] for k in after} == per_call
        assert all(v.startswith(("mma", "wgmma"))
                   for v in kqconv.variant_launches)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        with pytest.raises(ValueError, match="re-export"):
            load_exported(path, "cpu")
