"""The port's export (``densebox_tpu_torch/export.py``) on the CPU: artifacts
of the detect pipeline against the live port, against the JAX package's
StableHLO artifact, the exported graph's shape, the constant caches under
tracing, and a load that needs neither the JAX package nor the model code.

Width 0.125, 96 x 128 canvases, seeded numpy images; the weights are the
JAX init carried across by ``from_flax`` (float) and the JAX calibration by
``qparams_from_jax`` (int8). Bars: an artifact equals the live port bit for
bit (``torch.equal`` on every output); against the JAX artifact, the bars
of ``tests/test_torch_detect.py`` (valid equal, boxes to 1e-3 px, scores to
1e-4, on a seed whose scores are separated by more than that) and, with
landmarks, those of ``tests/test_torch_landmarks.py`` (lm_valid equal,
points to 1e-3 px). The int8 chains are held to the live port only: they
equal JAX's only when JAX runs without jit (``test_torch_quant*.py``), and a
JAX artifact is jitted.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from densebox_tpu import export as jax_export
from densebox_tpu.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu.models import DenseBox as JaxDenseBox
from densebox_tpu.models import quant as jax_quant
from densebox_tpu_torch import export as port_export
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox, from_flax,
                                       qparams_from_jax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYRAMID = (0.5, 0.7071, 1.0, 1.4142)
CANVAS = (96, 128)
LABEL = LabelCfg(patch_size=64, std_height_px=20.0)
LM_LABEL = dataclasses.replace(LABEL, lm_anchors=(
    (0.3, 0.3), (0.7, 0.3), (0.5, 0.5), (0.3, 0.7), (0.7, 0.7)))
TURBO = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.125)
PRE_NMS = 128
CASES = ("float_4scale", "int8_fused", "int8_hybrid", "int8_xla",
         "landmarks_refine")


def _images(seed=3, b=2):
    return np.random.RandomState(seed).rand(b, *CANVAS, 3).astype(np.float32)


def _infer(scales, **kw):
    return InferCfg(scales=scales, score_thresh=0.1, topk_per_scale=64,
                    pre_nms_topk=PRE_NMS, max_dets=16, **kw)


def _jax_init(cfg, loc_bias=0.0):
    params = jax.tree.map(np.asarray, JaxDenseBox(cfg).init(
        jax.random.key(1), jnp.zeros((1,) + CANVAS + (3,))))
    loc = params["params"]["loc"]["loc_conv2"]
    loc["bias"] = loc["bias"] + np.float32(loc_bias)
    return params


def _live_threshold(model, infer, x):
    """``infer`` with its threshold at the 90th percentile of the map
    candidates are decoded from, so that candidates reach NMS."""
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    smap = out.get("refined", out["score"]).float().numpy()
    return dataclasses.replace(infer,
                               score_thresh=float(np.quantile(smap, 0.9)))


def _case(name):
    """(port model, JAX model, JAX params or qparams, infer, label)."""
    x = _images()
    if name == "float_4scale":
        cfg = ModelCfg(width_mult=0.125)
        params = _jax_init(cfg)
        port = DenseBox(cfg, device="cpu")
        port.load_state_dict(from_flax(params, cfg))
        return port.eval(), JaxDenseBox(cfg), params, _infer(PYRAMID), LABEL
    if name == "landmarks_refine":
        cfg = ModelCfg(width_mult=0.125, num_landmarks=5, use_refine=True)
        params = _jax_init(cfg, loc_bias=1.0)
        port = DenseBox(cfg, device="cpu")
        port.load_state_dict(from_flax(params, cfg))
        infer = _live_threshold(port.eval(), _infer(
            PYRAMID, lm_dtype="float32", nms_backend="jax", lm_backend="jax"),
            x)
        return port, JaxDenseBox(cfg), params, infer, LM_LABEL
    backend = name.split("_")[1]
    qparams = jax.tree.map(np.asarray, jax_quant.quantize_densebox(
        _jax_init(TURBO), TURBO, jnp.asarray(x)))
    port = QuantDenseBox(TURBO, backend=backend, device="cpu")
    port.load_state_dict(qparams_from_jax(qparams, TURBO))
    infer = _live_threshold(port.eval(), _infer((1.0,)), x)
    return port, jax_quant.QuantDenseBox(TURBO), qparams, infer, LABEL


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each case exported once: name -> (port model, JAX model, its params,
    infer, label, ExportedProgram, artifact path)."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for name in CASES:
        model, jmodel, params, infer, label = _case(name)
        ep = port_export.export_detect_program(model, infer, label, 2, CANVAS,
                                               device="cpu")
        path = str(root / f"{name}.pt2")
        port_export.save_exported(path, ep, port_export.artifact_meta(
            model, infer, 2, CANVAS))
        out[name] = (model, jmodel, params, infer, label, ep, path)
    return out


def _live(model, infer, label, x):
    with torch.no_grad():
        return {k: v.numpy() for k, v in detect_batch(
            model, torch.from_numpy(x), infer, label).items()}


@pytest.mark.parametrize("name", CASES)
def test_artifact_equals_live_port(artifacts, name):
    model, _, _, infer, label, _, path = artifacts[name]
    call, meta = port_export.load_exported(path, "cpu")
    for seed in (3, 4):
        x = _images(seed)
        got = {k: v.numpy() for k, v in call(torch.from_numpy(x)).items()}
        want = _live(model, infer, label, x)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (name, seed, k)
        assert want["valid"].sum() > 10
    assert meta["batch"] == 2 and meta["canvas"] == list(CANVAS)
    assert meta["quantized"] == name.startswith("int8")
    assert meta["backend"] == (name.split("_")[1] if meta["quantized"]
                               else None)
    assert meta["landmarks"] == model.cfg.num_landmarks
    assert meta["scales"] == list(infer.scales)
    assert meta["device"] == "cpu" and meta["torch"] == torch.__version__
    if model.cfg.num_landmarks:
        assert want["lm_valid"].any()


def _assert_detections_match(got, want):
    """``tests/test_torch_detect.py``'s bars."""
    assert np.array_equal(got["valid"], want["valid"])
    v = want["valid"]
    for s in (want["scores"][i][v[i]] for i in range(len(v))):
        assert np.all(-np.diff(s) > 1e-4), "seed has near-tied scores"
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"][v], want["scores"][v],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["float_4scale", "landmarks_refine"])
def test_artifact_matches_jax_artifact(artifacts, tmp_path, name):
    _, jmodel, params, infer, label, _, path = artifacts[name]
    exported = jax_export.export_detect_program(jmodel, params, infer, label,
                                                2, CANVAS)
    jpath = str(tmp_path / "detect.stablehlo")
    jax_export.save_exported(jpath, exported, {"batch": 2})
    jcall, _ = jax_export.load_exported(jpath)
    call, _ = port_export.load_exported(path, "cpu")
    x = _images()
    want = {k: np.asarray(v) for k, v in jcall(x).items()}
    got = {k: v.numpy() for k, v in call(torch.from_numpy(x)).items()}
    assert set(got) == set(want) and want["valid"].sum() > 10
    _assert_detections_match(got, want)
    if "lm_points" in want:
        np.testing.assert_array_equal(got["lm_valid"], want["lm_valid"])
        np.testing.assert_allclose(got["lm_points"], want["lm_points"],
                                   atol=1e-3, rtol=0)


@pytest.mark.parametrize("name,kernels", [
    ("int8_fused", {"greedy_keep": 1, "qconv_int8": 14}),
    ("int8_hybrid", {"greedy_keep": 1, "qconv_int8": 14,
                     "requant_epilogue": 14}),
    ("int8_xla", {"greedy_keep": 1, "qconv_int8": 14}),
    ("float_4scale", {"greedy_keep": 1}),
    ("landmarks_refine", {"greedy_keep": 1, "gather_windows": 1})])
def test_graph_holds_one_node_per_kernel_launch(artifacts, name, kernels):
    """Each kernel of the path is one opaque node of the program, as many
    as the live path launches, and its plain version is not in it: the
    NMS sweep unrolled would add four or more nodes, one ``bitwise_not``
    among them, for each of the PRE_NMS candidates."""
    ep = artifacts[name][5]
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"]
    found = {}
    for n in nodes:
        ns, _, rest = str(n.target).partition(".")
        if ns == "densebox":
            found[rest.split(".")[0]] = found.get(rest.split(".")[0], 0) + 1
    assert found == kernels
    assert sum("bitwise_not" in str(n.target) for n in nodes) < 8
    if name.startswith("int8"):
        assert len(ep.graph.nodes) < 4 * PRE_NMS


def test_strict_json_metadata(artifacts):
    """The metadata line is strict JSON (no NaN or Infinity)."""
    path = artifacts["landmarks_refine"][6]
    with open(path, "rb") as f:
        assert f.read(len(port_export.MAGIC)) == port_export.MAGIC
        line = f.readline().decode()

    def refuse(name):
        raise ValueError(f"non-strict JSON constant {name}")

    meta = json.loads(line, parse_constant=refuse)
    assert meta == port_export.load_exported(path, "cpu")[1]
    assert meta["input"] == "(2, 96, 128, 3) float32 RGB in [0, 1]"


def test_load_on_another_device_is_refused(artifacts):
    path = artifacts["int8_fused"][6]
    with pytest.raises(ValueError, match="re-export"):
        port_export.load_exported(path, "meta")
    with pytest.raises(ValueError, match="not a densebox_tpu_torch export"):
        port_export.load_exported(os.path.join(REPO, "README.md"), "cpu")


_COLD_SCRIPT = """
import dataclasses, sys
import numpy as np
import torch
from densebox_tpu_torch import LabelCfg, ModelCfg, malf_face
from densebox_tpu_torch.export import DetectProgram
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import (DenseBox, QuantDenseBox, init_params,
                                       quantize_densebox)

x = torch.from_numpy(np.random.RandomState(0).rand(2, 96, 128, 3)
                     .astype(np.float32))
malf = malf_face()
lcfg = dataclasses.replace(malf.model, width_mult=0.125)
sd = init_params(lcfg, torch.Generator().manual_seed(0))
sd["loc.loc_conv2.bias"] += 1.0
lm = DenseBox(lcfg, device="cpu")
lm.load_state_dict(sd)
turbo = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.125)
q = QuantDenseBox(turbo, device="cpu")
q.load_state_dict(quantize_densebox(
    init_params(turbo, torch.Generator().manual_seed(0)), turbo, x))
infer = dataclasses.replace(malf.infer, score_thresh=-1e9, topk_per_scale=64,
                            pre_nms_topk=128, max_dets=16, lm_topk=8)
cases = [(lm.eval(), infer, malf.label),
         (q.eval(), dataclasses.replace(infer, scales=(1.0,)), LabelCfg())]
out = {}
with torch.no_grad():
    if sys.argv[1] == "export_first":
        # traced in a cold process: no constant is cached before the trace
        eps = [torch.export.export(DetectProgram(*c), (x,), strict=False)
               for c in cases]
        assert not q._consts, "the trace kept the int8 epilogue vectors"
        for i, ep in enumerate(eps):
            for k, v in ep.module()(x).items():
                out[f"program{i}_{k}"] = v.numpy()
    for i, c in enumerate(cases):
        for k, v in detect_batch(c[0], x, *c[1:]).items():
            assert type(v) is torch.Tensor, (k, type(v))
            out[f"live{i}_{k}"] = v.numpy()
np.savez(sys.argv[2], **out)
"""


def test_export_leaves_the_live_path_unchanged(tmp_path):
    """In a cold process a trace builds the constant tensors the live path
    caches (resize and upsample weights, per-scale tables, int8 epilogue
    vectors) as fake tensors; none is kept, so a live detect after the
    export equals one in a fresh process, and so does the program."""
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = {}
    for mode in ("export_first", "live"):
        path = str(tmp_path / f"{mode}.npz")
        res = subprocess.run([sys.executable, "-c", _COLD_SCRIPT, mode, path],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=600)
        assert res.returncode == 0, res.stdout + res.stderr
        outs[mode] = dict(np.load(path))
    first, fresh = outs["export_first"], outs["live"]
    assert set(fresh) == {k for k in first if k.startswith("live")}
    assert any(k.endswith("lm_points") for k in fresh)
    for k, want in fresh.items():
        assert np.array_equal(first[k], want), k
        assert np.array_equal(first["program" + k[len("live"):]], want), k


_BLOCKED_SCRIPT = """
import sys
from unittest import mock
sys.modules["densebox_tpu"] = None      # the JAX package cannot be imported
sys.modules["jax"] = None
import numpy as np
import torch
from densebox_tpu_torch import infer as infer_pkg
from densebox_tpu_torch import export
from densebox_tpu_torch.infer import detector
from densebox_tpu_torch.models import DenseBox, QuantDenseBox


def boom(*args, **kwargs):
    raise AssertionError("model code ran")


patches = [mock.patch.object(DenseBox, "forward", boom),
           mock.patch.object(QuantDenseBox, "forward", boom),
           mock.patch.object(QuantDenseBox, "_forward_xla", boom),
           mock.patch.object(detector, "detect_batch", boom),
           mock.patch.object(detector, "detect_from_maps", boom),
           mock.patch.object(infer_pkg, "detect_batch", boom),
           mock.patch.object(export, "detect_batch", boom)]
for p in patches:
    p.start()
call, meta = export.load_exported(sys.argv[1], "cpu")
x = torch.from_numpy(np.load(sys.argv[2]))
np.savez(sys.argv[3], **{k: v.numpy() for k, v in call(x).items()})
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in
                       ("jax", "flax", "jaxlib") and sys.modules[m]))
"""


def test_artifact_loads_without_jax_or_model_code(artifacts, tmp_path):
    """A process where ``densebox_tpu`` and ``jax`` cannot be imported and
    every model forward and ``detect_batch`` raise loads the int8 artifact
    and answers as the live port."""
    model, _, _, infer, label, _, path = artifacts["int8_fused"]
    x = _images(5)
    xpath, opath = str(tmp_path / "x.npy"), str(tmp_path / "out.npz")
    np.save(xpath, x)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SCRIPT, path, xpath, opath], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
    got = dict(np.load(opath))
    want = _live(model, infer, label, x)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
