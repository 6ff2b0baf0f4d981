"""The reference's precision inside the port (``device.reference_precision``),
on the CPU.

The JAX reference computes float32 at ``Precision.HIGHEST``; on the card
torch would run cuDNN's float32 convolutions on TF32 and may reduce bfloat16
products in reduced precision. The switches are plain Python settings of
torch, so where the port sets them is seen here without a card: each test
starts with all three switched on (TF32 allowed, reduced bf16 reduction
allowed), watches them from inside the port's forwards, train step,
resize, int8 chains and artifact call (a patched operation or a gradient
hook reads them), and checks that every switch is back as found
afterwards, after an exception too, and after two threads held inside
together.
"""

import dataclasses
import json
import threading
import types
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from densebox_tpu.models import densebox as jax_densebox
from densebox_tpu_torch import device, export
from densebox_tpu_torch.config import (DenseBoxConfig, InferCfg, LabelCfg,
                                       ModelCfg, TrainCfg)
from densebox_tpu_torch.data import synthetic_batch
from densebox_tpu_torch.infer import detect_batch, resize
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox, init_params,
                                       quantize_densebox)
from densebox_tpu_torch.models import densebox as densebox_module
from densebox_tpu_torch.models import quant as mq
from densebox_tpu_torch.parallel import spatial
from densebox_tpu_torch.train import create_train_state, make_train_step

ALL_ON = {"cudnn_tf32": True, "matmul_tf32": True, "bf16_reduction": True}
F32_HELD = {"cudnn_tf32": False, "matmul_tf32": False, "bf16_reduction": True}
INT8_HELD = {"cudnn_tf32": True, "matmul_tf32": True, "bf16_reduction": False}
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)
INFER = InferCfg(scales=(1.0, 0.5), score_thresh=-1e9, topk_per_scale=16,
                 max_dets=4, lm_topk=4)


def _cfg(dtype="float32", **kw):
    return ModelCfg(width_mult=0.125, compute_dtype=dtype, **kw)


def _set(flags):
    for name, (owner, attr) in device._SWITCHES.items():
        setattr(owner, attr, flags[name])


@pytest.fixture(autouse=True)
def switched_on():
    """Every test starts with all three switches on and leaves them as torch
    had them."""
    before = device.precision_flags()
    _set(ALL_ON)
    try:
        yield
    finally:
        _set(before)


def _model(cfg, seed=0):
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)))
    return model.eval()


def _images(b=2, h=64, w=64, seed=1):
    return torch.from_numpy(
        np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32))


def _convs_calling(before):
    """densebox.py's ``F`` with ``conv2d`` calling ``before()`` first."""
    def conv2d(*args, **kw):
        before()
        return F.conv2d(*args, **kw)

    return mock.patch.object(densebox_module, "F", types.SimpleNamespace(
        **{**vars(F), "conv2d": conv2d}))


def _watching_convs(seen):
    """densebox.py's ``F`` with ``conv2d`` reading the switches first."""
    return _convs_calling(lambda: seen.append(device.precision_flags()))


@pytest.mark.parametrize("dtype,int8,held", [
    ("float32", False, F32_HELD), (torch.float32, False, F32_HELD),
    ("bfloat16", False, ALL_ON), (torch.bfloat16, False, ALL_ON),
    ("bfloat16", True, INT8_HELD),
    ("float32", True, {k: False for k in ALL_ON})])
def test_helper_holds_and_restores(dtype, int8, held):
    with device.reference_precision(dtype, int8_chain=int8):
        assert device.precision_flags() == held
        with device.reference_precision(dtype, int8_chain=int8):
            assert device.precision_flags() == held
        assert device.precision_flags() == held
    assert device.precision_flags() == ALL_ON
    with pytest.raises(ZeroDivisionError):
        with device.reference_precision(dtype, int8_chain=int8):
            1 / 0
    assert device.precision_flags() == ALL_ON
    assert all(d == 0 for d in device._depth.values()) and not device._saved


def test_helper_restores_what_it_found():
    """A switch held off by one block and found off by a nested one comes
    back to the outer block's saved value, not to the inner's."""
    _set({"cudnn_tf32": False, "matmul_tf32": True, "bf16_reduction": True})
    with device.reference_precision("float32"):
        with device.reference_precision("bfloat16", int8_chain=True):
            assert device.precision_flags() == {k: False for k in ALL_ON}
        assert device.precision_flags() == F32_HELD
    assert device.precision_flags() == {
        "cudnn_tf32": False, "matmul_tf32": True, "bf16_reduction": True}


def test_f32_forward_holds_tf32_off_and_restores():
    model, seen = _model(_cfg()), []
    with _watching_convs(seen), torch.no_grad():
        model(_images())
    assert seen and all(s == F32_HELD for s in seen)
    assert device.precision_flags() == ALL_ON


def test_bf16_forward_leaves_tf32_as_found():
    model, seen = _model(_cfg("bfloat16")), []
    with _watching_convs(seen), torch.no_grad():
        model(_images())
    assert seen and all(s == ALL_ON for s in seen)
    assert device.precision_flags() == ALL_ON


def test_forward_restores_after_an_exception():
    """A forward that raises inside (an image the trunk cannot pool) puts
    every switch back."""
    seen = []
    with _watching_convs(seen), pytest.raises(ValueError, match="divisible"):
        _model(_cfg())(_images(h=60))
    assert device.precision_flags() == ALL_ON


def test_detect_batch_resize_and_forward_hold_tf32_off():
    """``detect_batch`` of an f32 model: the pyramid's resize products (jax's
    resize is at Precision.HIGHEST for any model) and every conv run with
    TF32 off; afterwards all is as found."""
    model, seen, resized = _model(_cfg()), [], []
    real = torch.einsum

    def einsum(*args):
        resized.append(device.precision_flags())
        return real(*args)

    with _watching_convs(seen), mock.patch.object(resize.torch, "einsum",
                                                  einsum), torch.no_grad():
        out = detect_batch(model, _images(), INFER, LABEL)
    assert out["boxes"].shape == (2, INFER.max_dets, 4)
    assert resized and all(s == F32_HELD for s in resized)
    assert seen and all(s == F32_HELD for s in seen)
    assert device.precision_flags() == ALL_ON


@pytest.mark.parametrize("canvas", [False, True])
def test_f32_train_step_holds_tf32_off_in_forward_and_backward(canvas):
    """Forward (a patched conv) and backward (a gradient hook on the first
    conv's weight, which autograd calls after the forward has returned) of
    an f32 train step, the canvas step too, run with TF32 off."""
    from densebox_tpu_torch.train.trainer import make_canvas_train_step

    cfg = DenseBoxConfig(model=_cfg(), label=LABEL,
                         train=TrainCfg(batch_size=2, max_boxes=3))
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    step = (make_canvas_train_step if canvas else make_train_step)(
        model, cfg, device="cpu")
    data = (dataclasses.replace(LABEL, patch_size=128) if canvas else LABEL)
    batch = synthetic_batch(torch.Generator().manual_seed(1), 2, data,
                            max_boxes=3, device="cpu")
    seen, in_backward = [], []
    model.conv1_1.weight.register_hook(
        lambda g: in_backward.append(device.precision_flags()))
    with _watching_convs(seen):
        _, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss_total"]))
    assert seen and all(s == F32_HELD for s in seen)
    assert in_backward == [F32_HELD]
    assert device.precision_flags() == ALL_ON


@pytest.mark.parametrize("backend", ["fused", "hybrid", "xla"])
def test_int8_chains_hold_bf16_reduction_off(backend):
    """Calibration and every int8 conv of the three chains run with reduced
    bf16 reduction off (the x2 upsample's bf16 products reduce in f32) and
    TF32 as found; afterwards all is as found."""
    cfg = _cfg("bfloat16", num_landmarks=4, use_refine=True)
    x = _images()
    calibrating, seen = [], []
    real_taps = mq.calibration_taps

    def taps(*args):
        calibrating.append(device.precision_flags())
        return real_taps(*args)

    with mock.patch.object(mq, "calibration_taps", taps):
        sd = quantize_densebox(init_params(cfg, torch.Generator().manual_seed(0)),
                               cfg, x)
    model = QuantDenseBox(cfg, backend=backend, device="cpu")
    model.load_state_dict(sd)
    real = mq.qconv_int8

    def qconv(*args, **kw):
        seen.append(device.precision_flags())
        return real(*args, **kw)

    with mock.patch.object(mq, "qconv_int8", qconv), torch.no_grad():
        out = model(x)
    assert set(out) == {"score", "loc", "lm", "refined"}
    assert calibrating == [INT8_HELD]
    assert len(seen) == len(mq.conv_names(cfg))
    assert all(s == INT8_HELD for s in seen)
    assert device.precision_flags() == ALL_ON

    def failing(*args, **kw):
        raise RuntimeError("conv failed")

    with mock.patch.object(mq, "qconv_int8", failing), \
            pytest.raises(RuntimeError, match="conv failed"):
        model(x)
    assert device.precision_flags() == ALL_ON


def test_spatial_forward_holds_tf32_off():
    """The spatial forward runs its own convs (``_conv_halo``): with TF32 off
    for an f32 model. One rank, no process group needed."""
    model, seen = _model(_cfg()), []
    real = spatial.F.conv2d

    def conv2d(*args, **kw):
        seen.append(device.precision_flags())
        return real(*args, **kw)

    ring = types.SimpleNamespace(
        n=1, rank=0, halo=lambda x: F.pad(x, (0, 0, 0, 0, 1, 1)),
        gather_rows=lambda x, h, lo: x)
    with mock.patch.object(spatial, "_Ring", lambda group: ring), \
            mock.patch.object(spatial.F, "conv2d", conv2d):
        maps = spatial.spatial_forward(model, _images())
    with torch.no_grad():
        want = model(_images())
    assert seen and all(s == F32_HELD for s in seen)
    for k in want:
        torch.testing.assert_close(maps[k], want[k], rtol=1e-5, atol=1e-5)
    assert device.precision_flags() == ALL_ON


def _artifact(tmp_path, meta):
    path = tmp_path / "a.pt2"
    path.write_bytes(export.MAGIC + (json.dumps(meta) + "\n").encode())
    return str(path)


@pytest.mark.parametrize("dtype,quantized,held", [
    ("float32", False, F32_HELD), ("bfloat16", False, ALL_ON),
    ("bfloat16", True, INT8_HELD), (None, False, F32_HELD),
    (None, True, {k: False for k in ALL_ON})])
def test_artifact_call_holds_the_recorded_precision(tmp_path, dtype,
                                                    quantized, held):
    """The switches are not part of a ``torch.export`` program: the loaded
    artifact's call enters the helper for the recorded compute dtype and
    int8 chain; an artifact written without ``compute_dtype`` (the
    format before it was recorded) runs at float32's."""
    cfg = _cfg(dtype or "bfloat16")
    model = (QuantDenseBox(cfg, device="cpu") if quantized
             else DenseBox(cfg, device="cpu"))
    meta = dict(export.artifact_meta(model, INFER, 2, (64, 64)),
                device="cpu", torch=torch.__version__)
    assert meta["compute_dtype"] == cfg.compute_dtype
    if dtype is None:
        del meta["compute_dtype"]
    seen = []

    def program(images):
        seen.append(device.precision_flags())
        return {"n": images.shape[0]}

    loaded = types.SimpleNamespace(module=lambda: program)
    with mock.patch.object(torch.export, "load", lambda f: loaded):
        call, got = export.load_exported(_artifact(tmp_path, meta), "cpu")
    assert got == meta
    assert call(_images()) == {"n": 2}
    assert seen == [held]
    assert device.precision_flags() == ALL_ON


def test_two_threads_leave_the_switches_as_found():
    """An f32 train step and an int8 detect in two threads, each held inside
    the port (a conv of the step, an int8 conv of the detect) until the
    other is inside too: inside, each sees its own switches off (and the
    other's too, they are the process's); afterwards every switch is back
    as found."""
    cfg = DenseBoxConfig(model=_cfg(), label=LABEL,
                         train=TrainCfg(batch_size=2, max_boxes=3))
    model = DenseBox(cfg.model, device="cpu")
    state = create_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), 2, LABEL,
                            max_boxes=3, device="cpu")
    qcfg = _cfg("bfloat16")
    qmodel = QuantDenseBox(qcfg, device="cpu")
    qmodel.load_state_dict(quantize_densebox(
        init_params(qcfg, torch.Generator().manual_seed(0)), qcfg, _images()))
    both = threading.Barrier(2, timeout=60)
    inside = {}
    real_qconv = mq.qconv_int8

    def at_conv():
        if "step" not in inside:
            both.wait()
            inside["step"] = device.precision_flags()

    def qconv(*args, **kw):
        if "detect" not in inside:
            both.wait()
            inside["detect"] = device.precision_flags()
        return real_qconv(*args, **kw)

    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            both.abort()

    threads = [threading.Thread(target=run, args=(lambda: step(state, batch),)),
               threading.Thread(target=run, args=(
                   lambda: detect_batch(qmodel, _images(), INFER, LABEL),))]
    with _convs_calling(at_conv), mock.patch.object(mq, "qconv_int8", qconv):
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert inside == {"step": {k: False for k in ALL_ON},
                      "detect": {k: False for k in ALL_ON}}
    assert device.precision_flags() == ALL_ON
    assert all(d == 0 for d in device._depth.values()) and not device._saved


@pytest.mark.parametrize("n", [4, 15, 40])
def test_bf16_upsample_rounds_each_product_once(n):
    """The bf16 x2 upsample takes its products in float32 and rounds each to
    bf16 once (cuBLAS's bf16 GEMM rounds rare elements otherwise): on the
    CPU that equals both the bf16 ``torch.bmm`` it replaces and the JAX
    reference's bf16 upsample, bit for bit; and it holds TF32 off while it
    multiplies."""
    x = np.random.RandomState(n).randn(2, n, n + 3, 64).astype(np.float32) * 3
    xb = torch.from_numpy(x).to(torch.bfloat16)
    seen = []
    real = torch.bmm

    def bmm(*args):
        seen.append((args[0].dtype, device.precision_flags()))
        return real(*args)

    with mock.patch.object(densebox_module.torch, "bmm", bmm):
        got = densebox_module.upsample2x_align_corners(xb)
    assert got.dtype == torch.bfloat16
    assert seen == [(torch.float32, F32_HELD)] * 2
    assert device.precision_flags() == ALL_ON
    b, h, w, c = xb.shape
    aw = densebox_module._interp_matrix(w, 2 * w, xb.device, xb.dtype)
    ah = densebox_module._interp_matrix(h, 2 * h, xb.device, xb.dtype)
    y = torch.bmm(aw.expand(b * h, 2 * w, w), xb.reshape(b * h, w, c))
    y = torch.bmm(ah.expand(b, 2 * h, h), y.reshape(b, h, 2 * w * c))
    assert torch.equal(got, y.reshape(got.shape))
    want = jax_densebox.upsample2x_align_corners(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
