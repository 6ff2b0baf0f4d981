"""The port's scripts (chip_smoke.py, profile_port.py) and the modules the
port names, checked without a card.

The scripts' device work runs only on a CUDA card. What holds here:
neither a script nor a module of the package names jax or any module of the
JAX package (the port keeps its own config and presets), importing the port
loads none of them, both scripts refuse to run without CUDA, and the plain
functions of profile_port.py do what its report says.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SCRIPTS = ["chip_smoke.py", "profile_port.py",
           "tools/probes/box_raster_variants.py"]
PACKAGE = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "densebox_tpu_torch", "**", "*.py"), recursive=True))
# modules of the JAX package that the port's package may import: none
PACKAGE_MAY_IMPORT = set()


def _imported(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SCRIPTS + PACKAGE)
def test_names_no_jax_module(path):
    allowed = PACKAGE_MAY_IMPORT if path in PACKAGE else set()
    bad = [m for m in _imported(path)
           if m.split(".")[0] in ("jax", "flax", "jaxlib", "optax", "orbax",
                                  "tensorflow")
           or (m.split(".")[0] == "densebox_tpu" and m not in allowed)]
    assert not bad, f"{path} imports {bad}"


_IMPORT_SCRIPT = """
import sys
import densebox_tpu_torch
import densebox_tpu_torch.train, densebox_tpu_torch.data
import densebox_tpu_torch.infer, densebox_tpu_torch.serve
import densebox_tpu_torch.ops.labels, densebox_tpu_torch.ops.ohem
import densebox_tpu_torch.train.checkpoint, densebox_tpu_torch.train.trainer
import densebox_tpu_torch.utils.logging, densebox_tpu_torch.utils.viz
import densebox_tpu_torch.cli, densebox_tpu_torch.eval
import densebox_tpu_torch.native
import densebox_tpu_torch.data.kitti, densebox_tpu_torch.data.pipeline
import densebox_tpu_torch.data.imageio
import densebox_tpu_torch.parallel, densebox_tpu_torch.parallel.mesh
import densebox_tpu_torch.parallel.spatial
import densebox_tpu_torch.parallel.multihost, densebox_tpu_torch.entry
import densebox_tpu_torch.export, densebox_tpu_torch.utils.constants
import chip_smoke, profile_port
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "flax", "jaxlib", "optax", "orbax", "tensorflow",
              "densebox_tpu"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_loads_no_jax():
    """Importing the port (its train, data and utils subpackages, the
    trainer, the checkpoints, the logger, the command line, eval, the KITTI
    reader, the loader and its native core, the image decoder, the
    multi-device layer ``parallel/``, ``entry.py``, ``export.py`` and both
    scripts included) in a fresh interpreter loads no module of jax, flax,
    jaxlib, optax, orbax, tensorflow or the JAX package."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_import_rule_covers_the_command_line_modules():
    """The static check above runs over every module of the command line's
    slice and of the multi-device slice (the parametrisation is a glob of
    the package)."""
    for path in ("cli.py", "eval.py", "native/__init__.py", "data/kitti.py",
                 "data/pipeline.py", "data/imageio.py", "utils/viz.py",
                 "utils/logging.py", "serve.py", "parallel/__init__.py",
                 "parallel/mesh.py", "parallel/spatial.py",
                 "parallel/multihost.py", "entry.py"):
        assert os.path.join("densebox_tpu_torch", path) in PACKAGE, path
    assert "chip_smoke.py" in SCRIPTS


_CV2_AT_TOP = ("cli.py", "eval.py", "serve.py", "data/imageio.py",
               "data/pipeline.py", "data/kitti.py", "utils/viz.py")


@pytest.mark.parametrize("path", _CV2_AT_TOP)
def test_cv2_is_imported_only_inside_functions(path):
    tree = ast.parse(open(os.path.join(REPO, "densebox_tpu_torch", path))
                     .read(), path)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top for a in n.names] + [
        n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert "cv2" not in names, f"{path} imports cv2 at module level"


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_refuses_without_cuda(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run in full")
    res = subprocess.run([sys.executable, script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is false" in res.stderr


def test_resize_products_equal_resize_linear():
    """The alternative that profile_port.py times against the kept resize
    computes the same result."""
    from densebox_tpu_torch.infer import pyramid_shapes, resize_linear
    from profile_port import resize_products

    x = torch.from_numpy(np.random.RandomState(0).rand(2, 96, 128, 3)
                         .astype(np.float32))
    for hs, ws, _, _ in pyramid_shapes(96, 128, (0.5, 0.7071, 1.4142)):
        torch.testing.assert_close(resize_products(x, (hs, ws)),
                                   resize_linear(x, (hs, ws)),
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,kind", [
    ("iou_mask_kernel(float4 const*, int, int, float)", "nms_kernel"),
    ("sweep_kernel(unsigned long long const*, unsigned char const*)",
     "nms_kernel"),
    ("void (anonymous namespace)::qconv_kernel<3, 64>(signed char const*, "
     "signed char const*, float const*)", "int8_conv_kernel"),
    ("void (anonymous namespace)::requant_kernel<int>(int const*, float "
     "const*)", "requant_kernel"),
    ("void (anonymous namespace)::window_kernel<unsigned short>(unsigned "
     "short const*, int const*, int const*, int const*, unsigned short*, "
     "int, int, int, int, int, int, int)", "window_kernel"),
    ("void (anonymous namespace)::ohem_kernel<8>(float const*, float const*, "
     "unsigned char const*)", "ohem_kernel"),
    ("(anonymous namespace)::boxes_kernel(float const*, float*, float4*, "
     "float*, int, int, float)", "rasterizer_kernel"),
    ("(anonymous namespace)::landmarks_kernel(float const*, float*, int, int, "
     "int)", "rasterizer_kernel"),
    ("(anonymous namespace)::boxes_kernel((anonymous namespace)::BoxArgs)",
     "rasterizer_kernel"),
    ("(anonymous namespace)::maps_kernel((anonymous namespace)::BoxArgs, "
     "(anonymous namespace)::LmArgs)", "rasterizer_kernel"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<2>", "optimizer"),
    ("sm90_xmma_wgrad_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc",
     "conv_backward"),
    ("sm80_xmma_dgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc",
     "conv_backward"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<float, "
     "float>", "max_pool"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "BinaryFunctor<float, float, float, binary_internal::MulFunctor<float>",
     "elementwise"),
    ("void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long>",
     "sort"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc"
     "<c10::BFloat16, int>", "max_pool"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "(anonymous namespace)::launch_clamp_scalar", "relu"),
    ("void at::native::elementwise_kernel<128, 4, at::native::"
     "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<c10", "add"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop",
     "conv"),
    ("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64",
     "gemm"),
    ("nvjet_tst_256x128_64x4_1x2_h_badd_coopA_TNT", "gemm"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::index_elementwise_kernel<128, 4>", "other"),
])
def test_kernel_kind(name, kind):
    from profile_port import kernel_kind

    assert kernel_kind(name) == kind
