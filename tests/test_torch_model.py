"""The PyTorch port's DenseBox forward against the JAX model.

Same weights (the Flax init, converted by densebox_tpu_torch.models.convert)
and the same numpy inputs through both; f32 maps agree to 1e-4 (the
heatmap-fidelity bar: only summation order differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.config import ModelCfg
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import densebox as jax_densebox
from densebox_tpu_torch.models import DenseBox, from_flax, init_params
from densebox_tpu_torch.models import densebox as port_densebox
from densebox_tpu_torch.ops import upsample as port_upsample
import torch_threads  # noqa: F401  (sets torch's threads)

STEMS = ("conv", "s2d", "s2d4")


def _flax_params(cfg, shape, seed=1):
    model = JaxDenseBox(cfg)
    params = model.init(jax.random.key(seed), jnp.zeros(shape, jnp.float32))
    return model, jax.tree.map(np.asarray, params)


def _port(cfg, params):
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(from_flax(params, cfg))
    return model.eval()


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("depth", [3, 4])
def test_trunk_plan_matches_jax(stem, depth):
    cfg = ModelCfg(stem=stem, trunk_depth=depth)
    assert port_densebox.trunk_plan(cfg) == jax_densebox.trunk_plan(cfg)


@pytest.mark.parametrize("r", [2, 4])
def test_space_to_depth_matches_jax(r):
    x = np.random.RandomState(r).rand(2, 8, 16, 3).astype(np.float32)
    want = np.asarray(jax_densebox.space_to_depth(jnp.asarray(x), r))
    got = port_densebox.space_to_depth(torch.from_numpy(x), r).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 4, 15])
def test_upsample_matches_jax(n):
    np.testing.assert_array_equal(
        port_upsample.interp_matrix_align_corners(n, 2 * n),
        jax_densebox.interp_matrix_align_corners(n, 2 * n))
    x = np.random.RandomState(n).rand(2, n, n + 3, 5).astype(np.float32)
    want = np.asarray(jax_densebox.upsample2x_align_corners(jnp.asarray(x)))
    got = port_upsample.upsample2x_align_corners(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("stem", STEMS)
@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("num_landmarks", [0, 4])
def test_forward_matches_jax_f32(stem, depth, num_landmarks):
    """Every head (score, loc, and with landmarks lm and refined) of every
    stem and depth, f32, to 1e-4."""
    cfg = ModelCfg(width_mult=0.125, stem=stem, trunk_depth=depth,
                   num_landmarks=num_landmarks, use_refine=bool(num_landmarks))
    img = np.random.RandomState(0).rand(2, 64, 96, 3).astype(np.float32)
    jmodel, params = _flax_params(cfg, img.shape)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    with torch.inference_mode():
        got = _port(cfg, params)(torch.from_numpy(img))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


def test_forward_bf16_close_to_jax():
    """bf16 compute: both frameworks round at their own places, so only a
    loose bound; shapes and f32 outputs as in the JAX model."""
    cfg = ModelCfg(width_mult=0.125, stem="s2d4", trunk_depth=3,
                   compute_dtype="bfloat16")
    img = np.random.RandomState(3).rand(1, 64, 96, 3).astype(np.float32)
    jmodel, params = _flax_params(cfg, img.shape)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(img))
    with torch.inference_mode():
        got = _port(cfg, params)(torch.from_numpy(img))
    for k in want:
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == want[k].shape
        scale = float(np.abs(np.asarray(want[k])).max())
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=0.1 * scale, err_msg=k)


def test_from_flax_names_and_layout():
    cfg = ModelCfg(width_mult=0.125, num_landmarks=2, use_refine=True)
    _, params = _flax_params(cfg, (1, 32, 32, 3))
    sd = from_flax(params, cfg)
    k = params["params"]["det"]["det_conv1"]["kernel"]          # HWIO
    np.testing.assert_array_equal(sd["det.det_conv1.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    assert "refine_out.bias" in sd and "lm.lm_conv2.weight" in sd
    with pytest.raises(ValueError, match="does not match"):
        from_flax(params, dataclasses.replace(cfg, num_landmarks=0,
                                              use_refine=False))
    with pytest.raises(ValueError, match="shape"):
        from_flax(params, dataclasses.replace(cfg, width_mult=0.25))


def test_init_params_he_normal():
    cfg = ModelCfg(width_mult=0.25)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    w = sd["conv3_2.weight"]
    fan_in = w.shape[1] * 9
    assert abs(float(w.std()) - (2.0 / fan_in) ** 0.5) < 0.05 * (2.0 / fan_in) ** 0.5
    assert float(w.abs().max()) <= 2 * (2.0 / fan_in) ** 0.5 / 0.8796 + 1e-6
    assert not sd["conv3_2.bias"].any()
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(sd)


def test_input_divisibility_raises():
    model = DenseBox(ModelCfg(width_mult=0.125), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros(1, 60, 64, 3))
