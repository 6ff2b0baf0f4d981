"""The port's int8 PTQ path against the JAX package, on the CPU.

Same float weights (the Flax init, converted by ``from_flax``) or the same
JAX qparams (converted by ``qparams_from_jax``), and the same numpy inputs.

Bars:
* plain int8 conv and requant against JAX's ``qconv_reference`` run
  eagerly, and the int8 forward against JAX's ``_forward_fused`` with its
  kernels replaced by their jnp twins under ``jax.disable_jit()``: exact.
  Run eagerly, XLA rounds every f32 operation on its own, as the port does;
  compiled (jit, or the Pallas interpret kernels) it contracts the
  epilogue's ``acc * scale + bias`` into one fused multiply-add;
* against the Pallas interpret kernels: int8 codes equal, f32 within the
  one rounding that the fused multiply-add skips;
* against the unpatched JAX int8 model: 2% of each output's scale, the bar
  ``tests/test_quant.py`` holds JAX's own hybrid and Pallas chains to;
* calibration: weights, weight scales and biases exact; input scales
  within one bf16 ulp (2^-8 relative), since both frameworks run the
  calibration convs in bf16 and may round their sums differently.
"""

import contextlib
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
from densebox_tpu.models import quant as jax_quant
from densebox_tpu.ops.pallas import qconv as jax_qconv
from densebox_tpu.ops.pallas import requant as jax_requant
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import (QuantDenseBox, from_flax,
                                       qparams_from_jax, quantize_densebox)
from densebox_tpu_torch.models import quant as port_quant
from densebox_tpu_torch.ops.kernels.qconv import (conv_accumulator,
                                                  qconv_int8, qconv_reference)
from densebox_tpu_torch.ops.kernels.requant import (requant_epilogue,
                                                    requant_reference)
from densebox_tpu_torch.serve import DetectServer

# The JAX package's own int8 test configs (tests/test_quant.py): the s2d4
# stem with landmarks and refine, and the conv stem (conv1_1 has Cin = 3).
CONFIGS = {
    "s2d4_lm3": ModelCfg(stem="s2d4", trunk_depth=2, width_mult=0.125,
                         num_landmarks=3, use_refine=True,
                         compute_dtype="bfloat16"),
    "conv_d4": ModelCfg(stem="conv", trunk_depth=4, width_mult=0.125,
                        compute_dtype="bfloat16"),
}
IMAGE = (2, 32, 40, 3)

# (B, H, W, Cin, Cout, k, int8 out): tests/test_pallas_kernels.py's qconv
# cases, then channel tails Cin = 3 and 5
CONV_CASES = [
    (2, 16, 24, 8, 16, 3, True), (1, 8, 80, 16, 32, 3, False),
    (2, 16, 33, 8, 16, 1, True), (2, 12, 40, 8, 8, 3, True),
    (2, 8, 24, 3, 16, 3, True), (1, 8, 20, 5, 4, 3, False),
]


def _conv_case(case):
    b, h, w_, cin, cout, k, quant = case
    rng = np.random.RandomState(sum(case))
    x = rng.randint(-127, 128, (b, h, w_, cin)).astype(np.int8)
    w = rng.randint(-20, 21, (k, k, cin, cout)).astype(np.int8)     # HWIO
    scale = rng.uniform(1e-3, 2e-3, cout).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    osc = rng.uniform(20, 40, cout).astype(np.float32) if quant else None
    return x, w, scale, bias, osc


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _port_w(w_hwio):
    return _t(np.transpose(w_hwio, (3, 0, 1, 2)))


def requant_twin(acc, scale, bias, out_scale=None, *, relu=True):
    """jnp twin of the Pallas ``requant_epilogue`` (its kernel body)."""
    y = acc.astype(jnp.float32) * scale + bias
    if relu:
        y = jnp.maximum(y, 0.0)
    if out_scale is None:
        return y
    return jnp.clip(jnp.round(y * out_scale), -127, 127).astype(jnp.int8)


@contextlib.contextmanager
def jax_twins():
    """JAX's fused chain with its two Pallas kernels replaced by their jnp
    twins, run eagerly: every f32 operation rounded on its own."""
    with mock.patch.object(jax_qconv, "qconv_int8", jax_qconv.qconv_reference), \
            mock.patch.object(jax_requant, "requant_epilogue", requant_twin), \
            jax.disable_jit():
        yield


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
@pytest.mark.parametrize("relu", [True, False])
def test_qconv_reference_matches_jax_eager(case, relu):
    x, w, scale, bias, osc = _conv_case(case)
    with jax.disable_jit():
        want = np.asarray(jax_qconv.qconv_reference(
            _j(x), _j(w), _j(scale), _j(bias), _j(osc), relu=relu))
    got = qconv_int8(_t(x), _port_w(w), _t(scale), _t(bias), _t(osc),
                     relu=relu)
    assert got.dtype == (torch.int8 if osc is not None else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # the int32 mode is XLA's int8 conv of the hybrid chain
    acc = np.asarray(jax_quant._int8_conv(_j(x), _j(w), pad=w.shape[0] // 2))
    got = qconv_reference(_t(x), _port_w(w), None, None, out="int32")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), acc)
    # requant of that accumulator is the same chain
    got = requant_epilogue(_t(acc), _t(scale), _t(bias), _t(osc), relu=relu)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_plain_versions_match_pallas_interpret(case):
    """The Pallas kernels in interpret mode fuse the epilogue's multiply and
    add: int8 codes still agree here, f32 values within that one rounding."""
    x, w, scale, bias, osc = _conv_case(case)
    acc = conv_accumulator(_t(x), _port_w(w)).numpy()
    got = qconv_reference(_t(x), _port_w(w), _t(scale), _t(bias), _t(osc))
    want = np.asarray(jax_qconv.qconv_int8(_j(x), _j(w), _j(scale), _j(bias),
                                           _j(osc), interpret=True))
    want_rq = np.asarray(jax_requant.requant_epilogue(
        _j(acc), _j(scale), _j(bias), _j(osc), interpret=True))
    got_rq = requant_reference(_t(acc), _t(scale), _t(bias), _t(osc))
    for g, w_ in ((got.numpy(), want), (got_rq.numpy(), want_rq)):
        if osc is not None:
            np.testing.assert_array_equal(g, w_)
        else:
            one_rounding = (np.spacing(np.abs(acc * scale, dtype=np.float32))
                            + np.spacing(np.abs(w_)))
            assert np.all(np.abs(g - w_) <= one_rounding)


def test_quant_weight_and_act_match_jax():
    rng = np.random.RandomState(0)
    w = rng.normal(0, 0.1, (3, 3, 24, 40)).astype(np.float32)        # HWIO
    w[..., 7] = 0.0                                  # an all-zero channel
    wq, ws = jax_quant._quant_weight(jnp.asarray(w))
    got_q, got_s = port_quant.quant_weight(_t(np.transpose(w, (3, 2, 0, 1))))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(),
                                  np.transpose(np.asarray(wq), (3, 0, 1, 2)))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ws))
    x = (rng.normal(0, 2, (2, 8, 8, 5)).astype(np.float32))
    xb = jnp.asarray(x, jnp.bfloat16)
    for scale in (np.float32(0.013), np.float32(3e-5)):
        want = np.asarray(jax_quant._quant_act(xb, jnp.asarray(scale)))
        got = port_quant.quant_act(torch.from_numpy(x).to(torch.bfloat16),
                                   torch.tensor(scale))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module", params=list(CONFIGS))
def quant_case(request):
    """(cfg, images, JAX float params, JAX qparams as numpy) for a config."""
    cfg = CONFIGS[request.param]
    x = np.random.RandomState(0).rand(*IMAGE).astype(np.float32)
    params = JaxDenseBox(cfg).init(jax.random.key(1), jnp.asarray(x))
    qparams = jax_quant.quantize_densebox(params, cfg, jnp.asarray(x))
    return (cfg, x, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, qparams))


def _port_model(cfg, qparams, backend="fused"):
    model = QuantDenseBox(cfg, backend=backend, device="cpu")
    model.load_state_dict(qparams_from_jax(qparams, cfg))
    return model.eval()


def test_quantize_densebox_matches_jax(quant_case):
    cfg, x, params, qparams = quant_case
    got = quantize_densebox(from_flax(params, cfg), cfg, torch.from_numpy(x))
    want = qparams_from_jax(qparams, cfg)
    assert set(got) == set(want)
    worst = 0.0
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if k.endswith(".in_scale") or k == "f4_scale":
            worst = max(worst, abs(float(got[k]) / float(v) - 1.0))
        else:
            assert torch.equal(got[k], v), k
    assert worst <= 2.0 ** -8


def test_quantize_densebox_head_invariant():
    cfg = CONFIGS["s2d4_lm3"]
    real = port_quant.calibration_taps

    def skewed(*args):
        taps = real(*args)
        taps["loc.loc_conv1"] = taps["loc.loc_conv1"] * 2
        return taps

    sd = from_flax(jax.tree.map(np.asarray, JaxDenseBox(cfg).init(
        jax.random.key(1), jnp.zeros(IMAGE))), cfg)
    with mock.patch.object(port_quant, "calibration_taps", skewed):
        with pytest.raises(ValueError, match="head conv1 input scales differ"):
            quantize_densebox(sd, cfg, torch.rand(*IMAGE))


@pytest.mark.parametrize("backend", ["pallas", "hybrid"])
def test_forward_matches_jax_eager_twins(quant_case, backend):
    cfg, x, _, qparams = quant_case
    with jax_twins():
        want = jax_quant.QuantDenseBox(cfg, backend=backend).apply(
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(x))
    port = _port_model(cfg, qparams,
                       "fused" if backend == "pallas" else "hybrid")
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["pallas", "hybrid"])
def test_forward_unequal_head_scales_matches_jax_eager_twins(quant_case,
                                                            backend):
    """A state whose heads' conv1 input scales differ (loaded from
    elsewhere: ``quantize_densebox`` makes them equal) quantises the shared
    features once per distinct scale, each head at its own: the maps of
    JAX's chain, which quantises them once per head."""
    cfg, x, _, qparams = quant_case
    qparams = dict(qparams)
    loc = dict(qparams["loc/loc_conv1"])
    loc["in_scale"] = loc["in_scale"] * np.float32(1.5)
    qparams["loc/loc_conv1"] = loc
    with jax_twins():
        want = jax_quant.QuantDenseBox(cfg, backend=backend).apply(
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(x))
    port = _port_model(cfg, qparams,
                       "fused" if backend == "pallas" else "hybrid")
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    others = [f"{p}.{p}_conv1" for p in port.heads if p != "loc"]
    assert port._neck_groups_of_state() == [others, ["loc.loc_conv1"]]
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("backend", ["pallas", "hybrid"])
def test_forward_close_to_jax_kernels(quant_case, backend):
    """Against JAX's chain as it runs (Pallas kernels in interpret mode)."""
    cfg, x, _, qparams = quant_case
    want = jax_quant.QuantDenseBox(cfg, backend=backend).apply(
        jax.tree.map(jnp.asarray, qparams), jnp.asarray(x))
    with torch.inference_mode():
        got = _port_model(cfg, qparams)(torch.from_numpy(x))
    for k in want:
        a = np.asarray(want[k], np.float32)
        scale = np.abs(a).max() + 1e-6
        assert np.abs(got[k].numpy() - a).max() / scale < 0.02, k


def test_fused_equals_hybrid(quant_case):
    cfg, x, _, qparams = quant_case
    with torch.inference_mode():
        a = _port_model(cfg, qparams, "fused")(torch.from_numpy(x))
        b = _port_model(cfg, qparams, "hybrid")(torch.from_numpy(x))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_qparams_from_jax_checks(quant_case):
    cfg, _, _, qparams = quant_case
    model = QuantDenseBox(cfg, device="cpu")
    assert not list(model.parameters())
    sd = qparams_from_jax(qparams, cfg)
    np.testing.assert_array_equal(
        sd["conv1_2.w_q"].numpy(),
        np.transpose(qparams["conv1_2"]["w_q"], (3, 0, 1, 2)))
    assert sd["f4_scale"].shape == ()
    model.load_state_dict(sd)
    missing = {k: v for k, v in qparams.items() if k != "f4_scale"}
    with pytest.raises(ValueError, match="does not match"):
        qparams_from_jax(missing, cfg)
    bad = dict(qparams, conv1_1=dict(qparams["conv1_1"],
                                     w_scale=np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="shape"):
        qparams_from_jax(bad, cfg)
    with pytest.raises(ValueError, match="backend"):
        QuantDenseBox(cfg, backend="pallas", device="cpu")


DET_CFG = ModelCfg(stem="s2d4", trunk_depth=2, width_mult=0.125,
                   compute_dtype="bfloat16")
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)


@pytest.fixture(scope="module")
def det_case():
    """A det-only int8 model (JAX qparams), images and a score threshold
    at the 90th percentile of its score map, so that candidates reach NMS."""
    x = np.random.RandomState(4).rand(2, 64, 96, 3).astype(np.float32)
    params = JaxDenseBox(DET_CFG).init(jax.random.key(2), jnp.asarray(x))
    qparams = jax.tree.map(np.asarray, jax_quant.quantize_densebox(
        params, DET_CFG, jnp.asarray(x)))
    model = _port_model(DET_CFG, qparams)
    with torch.inference_mode():
        smap = model(torch.from_numpy(x))["score"]
    thresh = float(np.quantile(smap.numpy(), 0.9))
    infer = InferCfg(scales=(1.0,), score_thresh=thresh, topk_per_scale=64,
                     pre_nms_topk=96, max_dets=16)
    return x, qparams, model, infer


def test_detect_batch_matches_jax(det_case):
    x, qparams, model, infer = det_case
    with jax_twins():
        want = jax_detector.detect_batch(
            jax_quant.QuantDenseBox(DET_CFG, backend="pallas"),
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(x), infer, LABEL)
    with torch.inference_mode():
        got = detect_batch(model, torch.from_numpy(x), infer, LABEL)
    assert np.asarray(want["valid"]).sum() > 4
    for k in ("valid", "boxes", "scores"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_server_round_trip(det_case):
    """The int8 model (buffers only) behind the CPU DetectServer: concurrent
    requests coalesce and each equals a direct detect of its canvas."""
    x, _, model, infer = det_case
    server = DetectServer(model, infer, LABEL, canvas_hw=(64, 96),
                          max_batch=2, batch_window_ms=50.0,
                          device="cpu")
    results = [None, None]

    def hit(i):
        results[i] = server.submit(x[i], timeout=60)

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.close()
    assert server.device == torch.device("cpu")
    assert server.stats["requests"] == 2
    with torch.inference_mode():
        want = detect_batch(model, torch.from_numpy(x), infer, LABEL)
    for i in range(2):
        v = want["valid"][i]
        assert v.any()
        np.testing.assert_array_equal(results[i]["boxes"],
                                      want["boxes"][i][v].numpy())
        np.testing.assert_array_equal(results[i]["scores"],
                                      want["scores"][i][v].numpy())
