"""The port's bench pipeline (``densebox_tpu_torch/bench.py``) against the
JAX bench's, on the CPU at the smoke shape (96 x 128, B=2, turbo trunk at
width 0.125, 2 calls).

JAX's parameters and the same images go through the port's
``bench.pipeline`` and through JAX's ``detect_batch`` run without jit,
call by call with the same ``i * 1e-6`` step:

* int8: the port's calibrated state on both sides (the port's calibration
  is held to JAX's in ``tests/test_torch_quant.py``); the ``fused`` chain
  against JAX's ``'pallas'`` chain with its kernels' jnp twins: identical
  detections;
* float32: ``tests/test_torch_detect.py``'s bars (identical keep sets,
  boxes to 1e-3 px, scores to 1e-4, on a seed whose kept scores lie more
  than 1e-4 apart);
* bfloat16: the two frameworks round bfloat16 at their own places (the
  forward differs by up to a bf16 ulp in most map elements: only
  ``tests/test_torch_model.py``'s loose bf16 bar holds, and no keep set
  can be held to JAX's), so the port's pipeline runs on JAX's own maps of
  the inputs it is given: the perturbed inputs and the detections
  identical to JAX's.

The checksums agree within what those bars allow over the summed elements
(4e-3 for a box's four coordinates and 1e-4 for its score per valid
float32 detection, 0 otherwise) plus the float32 rounding of the sums (1e-6
of their size).
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import InferCfg as JaxInferCfg
from densebox_tpu.config import LabelCfg as JaxLabelCfg
from densebox_tpu.config import ModelCfg as JaxModelCfg
from densebox_tpu.infer import detector as jax_detector
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import quant as jax_quant
from densebox_tpu.ops.pallas import qconv as jax_qconv
from densebox_tpu.ops.pallas import requant as jax_requant
from densebox_tpu_torch import bench
from densebox_tpu_torch.models import from_flax, quantize_densebox
import torch_threads  # noqa: F401  (sets torch's threads)


def _requant_twin(acc, scale, bias, out_scale=None, *, relu=True):
    y = acc.astype(jnp.float32) * scale + bias
    if relu:
        y = jnp.maximum(y, 0.0)
    if out_scale is None:
        return y
    return jnp.clip(jnp.round(y * out_scale), -127, 127).astype(jnp.int8)


def _jax_qparams(sd):
    """The port's int8 state_dict as the JAX package's qparams tree (the
    inverse of ``qparams_from_jax``)."""
    tree = {"f4_scale": jnp.asarray(sd["f4_scale"].numpy())}
    for k, v in sd.items():
        if k != "f4_scale":
            stem, leaf = k.rsplit(".", 1)
            a = v.numpy()
            if leaf == "w_q":
                a = np.transpose(a, (1, 2, 3, 0))        # -> HWIO
            tree.setdefault(stem.replace(".", "/"), {})[leaf] = jnp.asarray(a)
    return tree


def _checksum(out):
    return sum(float(np.where(np.isfinite(v), v, 0).astype(np.float64).sum())
               for v in (np.asarray(a, np.float32) for a in out.values()))


class _JaxMaps:
    """A port model that answers with JAX's maps of the images it is given
    (the bf16 case), recording those images."""

    def __init__(self, jmodel, params):
        self.jmodel, self.params, self.inputs = jmodel, params, []

    def __call__(self, images):
        x = images.float().numpy()
        self.inputs.append(x)
        with jax.disable_jit():
            out = self.jmodel.apply(self.params, jnp.asarray(x, jnp.bfloat16))
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in out.items()}


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_pipeline_matches_jax(dtype):
    args = bench.parse_args(["--smoke", "--dtype", dtype])
    hw, b, wm, iters, _ = bench.run_shape(args)
    cfg = bench.model_cfg(args, wm)
    jcfg = JaxModelCfg(width_mult=wm, compute_dtype=cfg.compute_dtype,
                       stem=cfg.stem, trunk_depth=cfg.trunk_depth)
    # images exactly representable in bf16, so both sides cast them alike;
    # seed 2 keeps float32's kept scores more than 1e-4 apart (seeds 0, 1
    # and 3 hold near-ties, which summation order may reorder)
    img = torch.from_numpy(np.random.RandomState(2).rand(b, *hw, 3)
                           .astype(np.float32)).bfloat16().float().numpy()
    jmodel = JaxDenseBox(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(1), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    # random weights: lift the score head so that candidates pass the
    # bench's 0.5 threshold, and the loc head so that boxes span a few map
    # pixels and overlap (NMS then suppresses)
    heads = params["params"]
    heads["det"]["det_conv2"]["bias"] = heads["det"]["det_conv2"]["bias"] + 0.6
    heads["loc"]["loc_conv2"]["bias"] = heads["loc"]["loc_conv2"]["bias"] + 0.5
    int8 = dtype == "int8"
    if int8:
        sd = quantize_densebox(from_flax(params, cfg), cfg,
                               torch.from_numpy(img[:2]))
        model, images = bench.build_infer(cfg, True, "fused", b, hw, "cpu",
                                          qparams=sd, images=img)
        jmodel = jax_quant.QuantDenseBox(jcfg, backend="pallas")
        params = _jax_qparams(sd)
    else:
        model, images = bench.build_infer(cfg, False, "fused", b, hw, "cpu",
                                          params=from_flax(params, cfg),
                                          images=img)
    if dtype == "bfloat16":
        model = _JaxMaps(jmodel, params)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(img, jdtype)
    icfg, lcfg = bench.infer_cfg(args), bench.LabelCfg()
    jicfg = JaxInferCfg(scales=(1.0,), score_thresh=0.5, topk_per_scale=256,
                        max_dets=128, approx_topk=True)
    calls = []
    real = bench.detect_batch

    def recorded(*a):
        out = real(*a)
        calls.append({k: v.float().numpy() for k, v in out.items()})
        return out

    with mock.patch.object(bench, "detect_batch", recorded):
        got_sum = float(bench.pipeline(model, images, icfg, lcfg, iters))
    want_sum, n_valid = 0.0, 0
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.disable_jit())
        if int8:
            stack.enter_context(mock.patch.object(
                jax_qconv, "qconv_int8", jax_qconv.qconv_reference))
            stack.enter_context(mock.patch.object(
                jax_requant, "requant_epilogue", _requant_twin))
        for i in range(iters):
            xi = x + jnp.asarray(i).astype(jdtype) * jnp.asarray(1e-6, jdtype)
            if dtype == "bfloat16":
                np.testing.assert_array_equal(
                    model.inputs[i], np.asarray(xi, np.float32))
            want = {k: np.asarray(v) for k, v in jax_detector.detect_batch(
                jmodel, params, xi, jicfg, JaxLabelCfg()).items()}
            got, v = calls[i], want["valid"]
            assert v.sum(1).min() > 10
            n_valid += int(v.sum())
            np.testing.assert_array_equal(got["valid"], v.astype(np.float32))
            if dtype == "float32":
                for s in (want["scores"][r][v[r]] for r in range(len(v))):
                    assert np.all(-np.diff(s) > 1e-4), "near-tied scores"
                np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                                           atol=1e-3, rtol=0)
                np.testing.assert_allclose(got["scores"][v],
                                           want["scores"][v], atol=1e-4,
                                           rtol=0)
            else:
                for k in want:
                    np.testing.assert_array_equal(
                        got[k], np.asarray(want[k], np.float32), err_msg=k)
            want_sum += _checksum(want)
    tol = (4.1e-3 * n_valid if dtype == "float32" else 0.0) \
        + 1e-6 * abs(want_sum)
    assert abs(got_sum - want_sum) <= tol, (got_sum, want_sum, tol)
