"""The port's pyramid resize, detect_batch and DetectServer against the JAX
package, on the same weights (the Flax init converted by
densebox_tpu_torch.models.convert) and the same numpy images.

Bars: identical valid counts, boxes to 1e-3 px, scores to 1e-4. The f32
maps differ by summation order (~1e-6), which can reorder two candidates
whose scores are closer than that; so each case first checks that the JAX
detections' scores are separated by more than 1e-4 (a property of the
seed, not of the port), then compares slot by slot.
"""

import os
import subprocess
import sys
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu.infer import detector as jax_detector
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu_torch.infer import (make_detect_fn, pyramid_shapes,
                                      resize_linear)
from densebox_tpu_torch.models import DenseBox, from_flax
from densebox_tpu_torch import serve as serve_module
from densebox_tpu_torch.serve import DetectServer
import torch_threads  # noqa: F401  (sets torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYRAMID = (0.5, 0.7071, 1.0, 1.4142)
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)


def _infer_cfg(scales, **kw):
    return InferCfg(scales=scales, score_thresh=0.1, topk_per_scale=64,
                    pre_nms_topk=128, max_dets=16, **kw)


@pytest.fixture(scope="module")
def models():
    cfg = ModelCfg(width_mult=0.125)
    jmodel = JaxDenseBox(cfg)
    params = jmodel.init(jax.random.key(1), jnp.zeros((1, 96, 128, 3)))
    port = DenseBox(cfg, device="cpu")
    port.load_state_dict(from_flax(jax.tree.map(np.asarray, params), cfg))
    return jmodel, params, port.eval()


def _images(seed, b=2, h=96, w=128):
    return np.random.RandomState(seed).rand(b, h, w, 3).astype(np.float32)


def _assert_detections_match(got, want):
    assert np.array_equal(got["valid"], want["valid"])
    v = want["valid"]
    for s in (want["scores"][i][v[i]] for i in range(len(v))):
        assert np.all(-np.diff(s) > 1e-4), "seed has near-tied scores"
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v],
                               atol=1e-4, rtol=0)


def test_pyramid_shapes_match_jax():
    for hw in ((96, 128), (480, 640), (37, 51)):
        assert (pyramid_shapes(*hw, PYRAMID)
                == jax_detector.pyramid_shapes(*hw, PYRAMID))


@pytest.mark.parametrize("scale", PYRAMID + (0.3536,))
def test_resize_matches_jax_image_resize(scale):
    img = _images(0)
    (hs, ws, _, _), = pyramid_shapes(96, 128, (scale,))
    want = jax.image.resize(jnp.asarray(img), (2, hs, ws, 3), method="linear")
    got = resize_linear(torch.from_numpy(img), (hs, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("scales", [(1.0,), PYRAMID], ids=["1scale", "4scale"])
def test_detect_batch_matches_jax(models, scales):
    jmodel, params, port = models
    infer = _infer_cfg(scales)
    img = _images(3)
    want = jax_detector.make_detect_fn(jmodel, infer, LABEL)(
        params, jnp.asarray(img))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in
           make_detect_fn(port, infer, LABEL)(torch.from_numpy(img)).items()}
    assert want["valid"].sum() > 10
    _assert_detections_match(got, want)


@pytest.mark.parametrize("scales", [(1.0,), PYRAMID], ids=["1scale", "4scale"])
def test_approx_topk_matches_jax(models, scales):
    """``approx_topk``: the JAX detect takes ``lax.approx_max_k`` (each
    level here has more positions than ``topk_per_scale``: 24 x 32 = 768 at
    scale 1), which off the TPU returns exactly ``lax.top_k``'s values and
    indices; the port reads the flag and takes the exact top-k. The JAX
    detections with the flag equal those without it bit for bit, and the
    port's equal them as in test_detect_batch_matches_jax."""
    jmodel, params, port = models
    infer = _infer_cfg(scales, approx_topk=True)
    img = _images(3)
    approx = []
    real = jax.lax.approx_max_k

    def spy(operand, k, **kw):
        approx.append((operand.shape, k))
        return real(operand, k, **kw)

    with mock.patch.object(jax.lax, "approx_max_k", spy):
        want = jax_detector.make_detect_fn(jmodel, infer, LABEL)(
            params, jnp.asarray(img))
    assert approx and all(k == 64 < n for (n,), k in approx)
    want = {k: np.asarray(v) for k, v in want.items()}
    exact = jax_detector.make_detect_fn(jmodel, _infer_cfg(scales), LABEL)(
        params, jnp.asarray(img))
    for key, v in exact.items():
        np.testing.assert_array_equal(want[key], np.asarray(v), err_msg=key)
    got = {k: v.numpy() for k, v in
           make_detect_fn(port, infer, LABEL)(torch.from_numpy(img)).items()}
    assert want["valid"].sum() > 10
    _assert_detections_match(got, want)


def test_server_submit_matches_jax(models):
    """A request smaller than the canvas is letterboxed (zero pad, no
    rescale) and comes back as JAX's detect of that canvas."""
    jmodel, params, port = models
    infer = _infer_cfg(PYRAMID)
    img = _images(3, b=1, h=80, w=112)[0]
    canvas = np.zeros((1, 96, 128, 3), np.float32)
    canvas[0, :80, :112] = img
    want = jax_detector.make_detect_fn(jmodel, infer, LABEL)(
        params, jnp.asarray(canvas))
    want = {k: np.asarray(v) for k, v in want.items()}
    server = DetectServer(port, infer, LABEL, canvas_hw=(96, 128),
                          max_batch=2, batch_window_ms=1.0, device="cpu")
    try:
        dets = server.submit(img)
    finally:
        server.close()
    v = want["valid"][0]
    assert v.sum() > 5
    _assert_detections_match(
        {"valid": np.ones((1, v.sum()), bool), "boxes": dets["boxes"][None],
         "scores": dets["scores"][None]},
        {"valid": np.ones((1, v.sum()), bool), "boxes": want["boxes"][:, v],
         "scores": want["scores"][:, v]})


@pytest.mark.parametrize("warmup", [True, False])
def test_server_warmup_runs_one_zero_batch_first(models, warmup):
    """``warmup`` (default on, as in the JAX server) runs one detect on a
    zero (max_batch, H, W, 3) batch in the constructor; it is no request
    and no device call of ``stats``, and results do not depend on it."""
    _, _, port = models
    calls = []
    real = serve_module.make_detect_fn

    def counting(*args, **kw):
        detect = real(*args, **kw)

        def wrapped(batch):
            calls.append((tuple(batch.shape), float(batch.abs().max())))
            return detect(batch)
        return wrapped

    kw = {} if warmup else {"warmup": False}
    with mock.patch.object(serve_module, "make_detect_fn", counting):
        server = DetectServer(port, _infer_cfg((1.0,)), LABEL,
                              canvas_hw=(96, 128), max_batch=2,
                              batch_window_ms=1.0, device="cpu", **kw)
    try:
        assert calls == ([((2, 96, 128, 3), 0.0)] if warmup else [])
        assert (server.stats["requests"],
                server.stats["device_calls"]) == (0, 0)
        dets = server.submit(_images(3, b=1, h=80, w=112)[0])
    finally:
        server.close()
    assert len(calls) == (2 if warmup else 1)
    assert (server.stats["requests"],
            server.stats["device_calls"]) == (1, 1)
    assert np.isfinite(dets["boxes"]).all() and len(dets["boxes"]) > 0


def test_server_coalesces_concurrent_requests(models):
    _, _, port = models
    server = DetectServer(port, _infer_cfg((1.0,)), LABEL,
                          canvas_hw=(96, 128), max_batch=4,
                          batch_window_ms=50.0, device="cpu")
    imgs = list(_images(5, b=6))
    results = [None] * 6

    def hit(i):
        results[i] = server.submit(imgs[i], timeout=60)

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
    assert all(r is not None and np.isfinite(r["boxes"]).all()
               for r in results)
    assert server.stats["requests"] == 6
    assert server.stats["device_calls"] < 6
    with pytest.raises(RuntimeError, match="server closed"):
        server.submit(imgs[0])


_NO_JAX_SCRIPT = """
import sys
import numpy as np
import torch
import chip_smoke, profile_port  # noqa: F401,E401 (module-level imports count)
from densebox_tpu_torch import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.models import DenseBox, init_params
from densebox_tpu_torch import serve as serve_module
from densebox_tpu_torch.serve import DetectServer

cfg = ModelCfg(width_mult=0.125)
model = DenseBox(cfg, device="cpu")
model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
infer = InferCfg(scales=(0.5, 1.0), score_thresh=-1e9, topk_per_scale=16,
                 pre_nms_topk=24, max_dets=8)
server = DetectServer(model, infer, LabelCfg(), canvas_hw=(64, 96),
                      max_batch=2, batch_window_ms=1.0, device="cpu")
try:
    dets = server.submit(np.random.RandomState(0).rand(64, 80, 3)
                         .astype(np.float32))
finally:
    server.close()
assert len(dets["boxes"]) == 8, dets
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "flax", "jaxlib", "densebox_tpu"))
# the JAX package's HTTP front end serves the port's server as it is
from densebox_tpu.serve import make_http_server
make_http_server(server, "127.0.0.1", 0).server_close()
print("LOADED", loaded)
sys.exit(1 if loaded else 0)
"""


def test_port_loads_no_jax():
    """A CPU detect-and-serve round trip through the port, in a fresh
    interpreter (this one has jax loaded by conftest), loads no jax, flax
    or jaxlib module and no module of the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
