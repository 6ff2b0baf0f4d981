"""The int8 conv of the port at the widths its models really run, on the CPU.

* ``kernel_variant`` names a variant of ``csrc/qconv.cu`` for every conv of
  the five models the port serves: the warpgroup one (``wgmma``) where Cin
  is a multiple of 32 and Cout at least 64, else the ``mma.sync`` one
  whenever Cin is a multiple of 16; ``wgmma_plan`` cuts a launch of the
  warpgroup variant by its shape.
* ``qconv_reference`` against the JAX package's ``qconv_reference`` at every
  distinct (Cin, Cout, k) of those models, on a small map whose height and
  width are no multiple of any tile, in the int8, f32 and int32 modes. JAX
  runs without jit: compiled, XLA contracts the epilogue's multiply and add
  into one fused multiply-add. Bar: equality (integer sums, then one
  separately rounded f32 operation at a time).
* ``QuantDenseBox`` keeps each conv's epilogue vectors from one forward to
  the next. Its maps equal, bit for bit, those of a forward that recomputes
  them at every call, and loading another state refreshes them.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu.models import quant as jax_quant
from densebox_tpu.ops.pallas import qconv as jax_qconv
from densebox_tpu_torch import ModelCfg, kitti_vehicle, malf_face
from densebox_tpu_torch.models import (QuantDenseBox, init_params,
                                       quantize_densebox)
from densebox_tpu_torch.models.quant import conv_shapes
from densebox_tpu_torch.ops.kernels.qconv import (DP4A_CHANNEL_BLOCKS,
                                                  MMA_CHANNEL_BLOCKS,
                                                  WGMMA_CHANNEL_BLOCKS,
                                                  kernel_variant, qconv_int8,
                                                  qconv_reference, wgmma_plan)
from densebox_tpu_torch.ops.kernels.requant import requant_epilogue
import torch_threads  # noqa: F401  (sets torch's threads)

TURBO = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.25)
MODELS = {
    "kitti_vehicle": kitti_vehicle().model,
    "malf_face": malf_face().model,
    "turbo": TURBO,
    "turbo_lm4": dataclasses.replace(TURBO, num_landmarks=4, use_refine=True),
    # the paper's car detector with 8 landmarks and the refine branch
    "kitti_vehicle_lm8": dataclasses.replace(kitti_vehicle().model,
                                             num_landmarks=8, use_refine=True),
}


def _model_widths():
    """Every distinct (Cin, Cout, k) among the convs of ``MODELS``."""
    seen = set()
    for cfg in MODELS.values():
        seen |= {(cin, cout, k) for cout, cin, k, _ in
                 conv_shapes(cfg).values()}
    return sorted(seen)


WIDTHS = _model_widths()


def _path(cin, cout):
    return ("wgmma" if cin % 32 == 0 and cout >= 64
            else "mma" if cin % 16 == 0 else "dp4a")


@pytest.mark.parametrize("name", list(MODELS))
def test_kernel_variant_covers_model(name):
    shapes = conv_shapes(MODELS[name])
    assert len(shapes) >= 14
    blocks_of = {"wgmma": WGMMA_CHANNEL_BLOCKS, "mma": MMA_CHANNEL_BLOCKS,
                 "dp4a": DP4A_CHANNEL_BLOCKS}
    for conv, (cout, cin, k, _) in shapes.items():
        path, block = kernel_variant(cin, cout, k).split("_n")
        assert path == _path(cin, cout), conv
        blocks = blocks_of[path]
        assert int(block) in blocks, conv
        # the smallest block that holds Cout, the largest above that
        assert int(block) == min([n for n in blocks if n >= cout]
                                 or [blocks[-1]]), conv
    if name.startswith("turbo"):
        trunk_and_heads = [kernel_variant(cin, cout, k)
                           for conv, (cout, cin, k, _) in shapes.items()
                           if not conv.startswith("refine")]
        assert all(v.startswith(("mma", "wgmma")) for v in trunk_and_heads)
    if name.startswith("kitti"):
        # the paper's trunk from conv1_2 on and the heads' conv1 take the
        # warpgroup variant; conv1_1 (Cin 3) and the heads' conv2 (Cout <= 8)
        # do not
        for conv, (cout, cin, k, _) in shapes.items():
            head_conv2 = "." in conv and conv.endswith("_conv2")
            wide = conv not in ("conv1_1", "refine_conv1", "refine_out") \
                and not head_conv2
            assert kernel_variant(cin, cout, k).startswith("wgmma") == wide, \
                conv


@pytest.mark.parametrize("cin,cout,k,want", [
    (48, 16, 3, "mma_n16"), (64, 64, 3, "wgmma_n64"), (128, 1, 1, "mma_n8"),
    (512, 5, 1, "mma_n8"), (16, 9, 3, "mma_n16"), (768, 512, 1, "wgmma_n128"),
    (80, 130, 3, "mma_n128"), (3, 64, 3, "dp4a_n64"), (6, 64, 3, "dp4a_n64"),
    (5, 24, 3, "dp4a_n32"), (5, 4, 3, "dp4a_n16"), (24, 200, 1, "dp4a_n64"),
    (9, 64, 3, "dp4a_n64"), (512, 8, 1, "mma_n8"),
])
def test_kernel_variant_rule(cin, cout, k, want):
    assert kernel_variant(cin, cout, k) == want


# The warpgroup rule at its edges: Cin a multiple of 32 (not 16 alone), Cout
# at least 64; the kernel size never enters it.
_EDGE_VARIANTS = {
    16: ("mma_n8", "mma_n32", "mma_n64", "mma_n128", "mma_n128", "mma_n128"),
    32: ("mma_n8", "mma_n32", "wgmma_n64", "wgmma_n128", "wgmma_n128",
         "wgmma_n128"),
    48: ("mma_n8", "mma_n32", "mma_n64", "mma_n128", "mma_n128", "mma_n128"),
    64: ("mma_n8", "mma_n32", "wgmma_n64", "wgmma_n128", "wgmma_n128",
         "wgmma_n128"),
    768: ("mma_n8", "mma_n32", "wgmma_n64", "wgmma_n128", "wgmma_n128",
          "wgmma_n128"),
}
_EDGE_COUTS = (8, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", _EDGE_COUTS)
@pytest.mark.parametrize("cin", sorted(_EDGE_VARIANTS))
def test_kernel_variant_wgmma_edges(cin, cout, k):
    want = _EDGE_VARIANTS[cin][_EDGE_COUTS.index(cout)]
    assert kernel_variant(cin, cout, k) == want


# (Cin, Cout, k) -> weights resident, pixels a block: resident where all
# taps' weights of a channel block fit beside two input stages (each
# consumer warpgroup on its own 128-pixel tiles), else streamed (256)
@pytest.mark.parametrize("width,resident,tile", [
    ((64, 64, 3), True, 128),       # kitti conv1_2, refine_conv2
    ((64, 128, 3), True, 128),      # conv2_1
    ((128, 128, 3), True, 128),     # conv2_2: 147 KB beside 2 x 30 KB
    ((128, 256, 3), True, 128),     # conv3_1: the same a channel block
    ((256, 256, 3), False, 256),    # conv3_2: 295 KB
    ((256, 512, 3), False, 256),    # conv4_1
    ((512, 512, 3), False, 256),    # conv4_2 .. conv4_4
    ((768, 512, 1), True, 128),     # the heads' conv1: 98 KB
    ((2048, 128, 1), False, 256),   # 1x1, 256 KB
    ((160, 128, 3), True, 128),     # Cin 160: chunks of 32, 184 KB
    ((192, 128, 3), False, 256),    # 221 KB
    ((32, 64, 3), True, 128),       # the turbo models' narrowest
])
def test_wgmma_plan_follows_the_widths(width, resident, tile):
    assert wgmma_plan(*width) == {"weights_resident": resident,
                                  "tile_pixels": tile}


@pytest.mark.parametrize("cin,cout,k", [(16, 16, 2), (0, 16, 3), (16, 0, 1),
                                        (16, 16, 5)])
def test_kernel_variant_refuses(cin, cout, k):
    with pytest.raises(ValueError, match="kernel_variant"):
        kernel_variant(cin, cout, k)


def _width_case(cin, cout, k):
    """A ragged map (B=2, 11x19) over the whole code range, with epilogue
    vectors that put y at a few units so that int8 outputs round and clip."""
    rng = np.random.RandomState(cin * 1000 + cout * 10 + k)
    x = rng.randint(-127, 128, (2, 11, 19, cin)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, cin, cout)).astype(np.int8)    # HWIO
    spread = 127.0 * 127.0 * np.sqrt(k * k * cin)
    scale = (rng.uniform(2.0, 6.0, cout) / spread).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, cout).astype(np.float32)
    osc = rng.uniform(20.0, 40.0, cout).astype(np.float32)
    return x, w, scale, bias, osc


@pytest.mark.parametrize("width", WIDTHS, ids=str)
@pytest.mark.parametrize("mode", ["int8", "f32", "int32"])
def test_qconv_reference_matches_jax_at_model_widths(width, mode):
    x, w, scale, bias, osc = _width_case(*width)
    k = width[2]
    port_w = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2)))
    tx = torch.from_numpy(x)
    if mode == "int32":
        want = np.asarray(jax_quant._int8_conv(jnp.asarray(x), jnp.asarray(w),
                                               pad=k // 2))
        got = qconv_int8(tx, port_w, None, None, out="int32")
        assert got.dtype == torch.int32
    else:
        q = jnp.asarray(osc) if mode == "int8" else None
        with jax.disable_jit():
            want = np.asarray(jax_qconv.qconv_reference(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                jnp.asarray(bias), q, relu=mode == "int8"))
        got = qconv_int8(tx, port_w, torch.from_numpy(scale),
                         torch.from_numpy(bias),
                         torch.from_numpy(osc) if mode == "int8" else None,
                         relu=mode == "int8")
        assert got.dtype == (torch.int8 if mode == "int8" else torch.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if mode == "int8":
        assert want.max() == 127 and len(np.unique(want)) > 50


def _per_call_conv(self, x_q, name, nxt, *, relu=True):
    """``QuantDenseBox._conv`` as it was before the constants were kept:
    every epilogue value recomputed from the buffers at every call."""
    q = self._q[name]
    out_scale = 1.0 / self._q[nxt].in_scale if nxt is not None else None
    scale = q.in_scale * q.w_scale
    if self.backend == "hybrid":
        acc = qconv_int8(x_q, q.w_q, None, None, out="int32")
        return requant_epilogue(acc, scale, q.bias, out_scale, relu=relu)
    return qconv_int8(x_q, q.w_q, scale, q.bias, out_scale, relu=relu)


CACHE_CFG = ModelCfg(stem="s2d4", trunk_depth=2, width_mult=0.125,
                     num_landmarks=3, use_refine=True,
                     compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def cache_case():
    x = torch.from_numpy(np.random.RandomState(11).rand(2, 32, 40, 3)
                         .astype(np.float32))
    sd = quantize_densebox(
        init_params(CACHE_CFG, torch.Generator().manual_seed(3)), CACHE_CFG, x)
    return x, sd


def _forward(model, x, per_call=False):
    with torch.inference_mode():
        if per_call:
            with mock.patch.object(QuantDenseBox, "_conv", _per_call_conv):
                return model(x)
        return model(x)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_cached_constants_change_no_output(cache_case, backend):
    x, sd = cache_case
    model = QuantDenseBox(CACHE_CFG, backend=backend, device="cpu").eval()
    model.load_state_dict(sd)
    want = _forward(model, x, per_call=True)
    assert not model._consts                # the old arithmetic kept nothing
    first = _forward(model, x)
    n_convs = len(conv_shapes(CACHE_CFG))
    assert len(model._consts) == n_convs
    kept = {k: v[0].data_ptr() for k, v in model._consts.items()}
    second = _forward(model, x)             # now from the kept vectors
    assert {k: v[0].data_ptr() for k, v in model._consts.items()} == kept
    _assert_same(first, want)
    _assert_same(second, want)
    for scale, bias, out_scale in model._consts.values():
        for v in (scale, bias) + (() if out_scale is None else (out_scale,)):
            assert v.dtype == torch.float32 and v.is_contiguous()
            assert v.shape == scale.shape and v.dim() == 1


def test_load_state_dict_refreshes_constants(cache_case):
    x, sd = cache_case
    model = QuantDenseBox(CACHE_CFG, device="cpu").eval()
    model.load_state_dict(sd)
    first = _forward(model, x)
    other = {k: (v * 1.75 if k.endswith(".in_scale") or k == "f4_scale"
                 else v.clone()) for k, v in sd.items()}
    model.load_state_dict(other)
    assert not model._consts
    got = _forward(model, x)
    _assert_same(got, _forward(model, x, per_call=True))
    assert any(not torch.equal(got[k], first[k]) for k in got)
    # the names and contents of the state did not change with the cache
    assert set(model.state_dict()) == set(sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other[k]), k


def test_refresh_constants_after_in_place_change(cache_case):
    x, sd = cache_case
    model = QuantDenseBox(CACHE_CFG, device="cpu").eval()
    model.load_state_dict(sd)
    _forward(model, x)
    with torch.no_grad():
        model.get_buffer("conv1_2.in_scale").mul_(0.5)
    stale = _forward(model, x)
    model.refresh_constants()
    fresh = _forward(model, x)
    _assert_same(fresh, _forward(model, x, per_call=True))
    assert any(not torch.equal(fresh[k], stale[k]) for k in fresh)
