"""The port's repair of slot-dependent convolutions, on the CPU.

``models/densebox.py:slot_safe`` finds, once per shape, whether cuDNN's
batched call of a convolution gives an image the same bits in every slot,
and ``split_by_image`` then runs a batch that fails it one image a call (on
the card, without autograd). What holds here:

* the CPU keeps the one batched call, so the port's CPU maps are exactly
  what the plain ``F.conv2d`` body gives, and within the JAX bars that
  ``tests/test_torch_model.py`` holds (1e-4 for float32 maps);
* ``slot_safe`` tells a slot-dependent convolution from a safe one, once
  per shape;
* the per-image path (forced) gives every image the same maps in every
  slot of a batch, within the same JAX bars.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from densebox_tpu.config import ModelCfg
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu_torch.models import DenseBox, from_flax
from densebox_tpu_torch.models import densebox as port_densebox

CFGS = {
    "paper": ModelCfg(width_mult=0.125),
    "malf": ModelCfg(width_mult=0.125, num_landmarks=5, use_refine=True),
    "turbo": ModelCfg(width_mult=0.25, stem="s2d4", trunk_depth=3),
}
IMAGES = (4, 40, 56, 3)         # conv4 at 5 x 7: odd map sides


def _models(cfg):
    jmodel = JaxDenseBox(cfg)
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(1), jnp.zeros(IMAGES, jnp.float32)))
    port = DenseBox(cfg, device="cpu")
    port.load_state_dict(from_flax(params, cfg))
    return jmodel, params, port.eval()


def _plain_conv(self, conv, x):
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=conv.padding)


def _images(seed=0):
    return np.random.RandomState(seed).rand(*IMAGES).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cpu_maps_are_the_batched_calls_and_hold_the_jax_bars(name):
    jmodel, params, port = _models(CFGS[name])
    img = _images()
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
        with mock.patch.object(DenseBox, "_conv", _plain_conv):
            plain = port(torch.from_numpy(img))
    want = jmodel.apply(params, jnp.asarray(img))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], plain[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)


def test_slot_safe_finds_a_slot_dependent_conv_once_per_shape():
    x = torch.rand(4, 8, 5, 7).to(memory_format=torch.channels_last)
    w, b = torch.randn(16, 8, 3, 3), torch.randn(16)
    calls, conv2d = [], F.conv2d

    def by_slot(inp, w_, b_, padding):
        calls.append(inp.shape)
        y = conv2d(inp, w_, b_, padding=padding)
        return y + 1e-3 * torch.arange(inp.shape[0]).view(-1, 1, 1, 1)

    with mock.patch.dict(port_densebox._slot_safe, clear=True):
        assert port_densebox.slot_safe(x, w, b, (1, 1))
        with mock.patch.object(port_densebox.F, "conv2d", by_slot):
            assert not port_densebox.slot_safe(x[:3], w, b, (1, 1))
            assert not port_densebox.slot_safe(x[:3], w, b, (1, 1))
            assert port_densebox.slot_safe(x, w, b, (1, 1))   # kept
        assert calls == [torch.Size([3, 8, 5, 7])]


def test_slot_safe_is_not_asked_on_the_cpu_or_with_autograd():
    x = torch.rand(4, 8, 5, 7)
    w, b = torch.randn(16, 8, 3, 3), torch.randn(16)
    with mock.patch.object(port_densebox, "slot_safe",
                           side_effect=AssertionError("asked")):
        with torch.inference_mode():
            assert not port_densebox.split_by_image(x, w, b, (1, 1))
        assert not port_densebox.split_by_image(x, w, b, (1, 1))


@pytest.mark.parametrize("name", ["paper", "malf"])
def test_per_image_path_is_slot_independent_within_the_jax_bars(name):
    """Forced on the CPU: each image's maps the same in every slot (the
    batch rolled through all its slots), and within 1e-4 of JAX's."""
    jmodel, params, port = _models(CFGS[name])
    img = _images(1)
    want = jmodel.apply(params, jnp.asarray(img))
    x = torch.from_numpy(img)
    with torch.inference_mode(), mock.patch.object(
            port_densebox, "split_by_image", lambda *a: True):
        base = port(x)
        for k in want:
            np.testing.assert_allclose(base[k].numpy(), np.asarray(want[k]),
                                       atol=1e-4, err_msg=k)
        for s in range(1, x.shape[0]):
            out = port(torch.roll(x, s, 0))
            for k, v in out.items():
                assert torch.equal(torch.roll(v, -s, 0), base[k]), (s, k)
