"""The port's ``QuantDenseBox(backend='xla')`` against the JAX package's
default int8 chain (``QuantDenseBox(backend='xla')``, ``_forward`` with
qparams at its 'auto' settings), on the CPU.

Same JAX qparams (``qparams_from_jax``), same numpy images. JAX runs
eagerly (``jax.disable_jit()``): every f32 operation is then rounded on its
own, as the port rounds ``f32(acc) * scale`` and ``+ bias`` apart (jitted,
XLA would contract them into one fused multiply-add). Bars: every int8
code that enters a conv identical, in order, and every output map identical
(the bar ``tests/test_torch_quant.py`` holds the fused chain to against
JAX's eager twins).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import ModelCfg
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import quant as jax_quant
from densebox_tpu_torch.models import QuantDenseBox, qparams_from_jax
from densebox_tpu_torch.models import quant as port_quant

CONFIGS = {
    "det_conv_d4": ModelCfg(stem="conv", trunk_depth=4, width_mult=0.125,
                            compute_dtype="bfloat16"),
    "lm4_refine_s2d4": ModelCfg(stem="s2d4", trunk_depth=2, width_mult=0.125,
                                num_landmarks=4, use_refine=True,
                                compute_dtype="bfloat16"),
}
IMAGE = (2, 32, 40, 3)


@pytest.fixture(scope="module", params=list(CONFIGS))
def xla_case(request):
    cfg = CONFIGS[request.param]
    x = np.random.RandomState(7).rand(*IMAGE).astype(np.float32)
    params = JaxDenseBox(cfg).init(jax.random.key(3), jnp.asarray(x))
    qparams = jax_quant.quantize_densebox(params, cfg, jnp.asarray(x))
    return cfg, x, jax.tree.map(np.asarray, qparams)


def _jax_xla(cfg, x, qparams):
    """JAX's 'xla' chain run eagerly; the int8 codes each conv reads."""
    codes = []
    real = jax_quant._int8_conv

    def recording(x_q, wq, **kw):
        codes.append(np.asarray(x_q))
        return real(x_q, wq, **kw)

    with mock.patch.object(jax_quant, "_int8_conv", recording), \
            jax.disable_jit():
        out = jax_quant.QuantDenseBox(cfg).apply(
            jax.tree.map(jnp.asarray, qparams), jnp.asarray(x))
    return {k: np.asarray(v) for k, v in out.items()}, codes


def _port_xla(cfg, x, qparams):
    codes = []
    real = port_quant.qconv_int8

    def recording(x_q, *args, **kw):
        codes.append(x_q.numpy().copy())
        return real(x_q, *args, **kw)

    model = QuantDenseBox(cfg, backend="xla", device="cpu")
    model.load_state_dict(qparams_from_jax(qparams, cfg))
    with mock.patch.object(port_quant, "qconv_int8", recording), \
            torch.inference_mode():
        out = model.eval()(torch.from_numpy(x))
    return {k: v.numpy() for k, v in out.items()}, codes


def test_xla_chain_equals_jax_in_every_code(xla_case):
    cfg, x, qparams = xla_case
    assert jax_quant.QuantDenseBox(cfg).backend == "auto"   # resolves 'xla'
    want, want_codes = _jax_xla(cfg, x, qparams)
    got, got_codes = _port_xla(cfg, x, qparams)
    assert len(got_codes) == len(want_codes) == len(
        port_quant.conv_names(cfg))
    for i, (g, w) in enumerate(zip(got_codes, want_codes)):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w, err_msg=f"conv {i}")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_xla_chain_launches_only_the_int32_conv(xla_case):
    """One int32-accumulator conv per conv of the model and no requant
    launch: the 'xla' chain's epilogue is torch, not a kernel."""
    cfg, x, qparams = xla_case
    model = QuantDenseBox(cfg, backend="xla", device="cpu")
    model.load_state_dict(qparams_from_jax(qparams, cfg))
    modes = []
    real = port_quant.qconv_int8

    def recording(*args, out="int8", **kw):
        modes.append(out)
        return real(*args, out=out, **kw)

    with mock.patch.object(port_quant, "qconv_int8", recording), \
            mock.patch.object(port_quant, "requant_epilogue",
                              side_effect=AssertionError("requant")), \
            torch.inference_mode():
        model(torch.from_numpy(x))
    assert modes == ["int32"] * len(port_quant.conv_names(cfg))
    assert "xla" in port_quant.BACKENDS


def test_xla_chain_differs_from_fused(xla_case):
    """Another chain than 'fused' (bf16 between the convs, not int8), close
    to it: within 15% of each map's scale, the bar
    ``tests/test_quant.py::test_fused_pallas_backend_tracks_xla_backend``
    holds JAX's own two chains to."""
    cfg, x, qparams = xla_case
    outs = {}
    for backend in ("fused", "xla"):
        model = QuantDenseBox(cfg, backend=backend, device="cpu")
        model.load_state_dict(qparams_from_jax(qparams, cfg))
        with torch.inference_mode():
            outs[backend] = model(torch.from_numpy(x))
    for k, a in outs["fused"].items():
        b = outs["xla"][k]
        scale = float(a.abs().max()) + 1e-6
        assert float((a - b).abs().max()) / scale < 0.15, k
    assert not torch.equal(outs["fused"]["score"], outs["xla"]["score"])
