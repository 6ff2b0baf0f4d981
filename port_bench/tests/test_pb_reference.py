"""The benchmark's plain reference against the port at a tiny size on the
CPU, where the port runs its plain kernel versions: the float forward, the
int8 chain's calibration and codes, the pyramid's resize, decode and NMS,
and the landmark decode.

Tests may hand the port's own int8 scales to the reference to hold the
chain's codes bit for bit; the benchmark's check never does."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.infer import detect_from_maps, pyramid_maps
from densebox_tpu_torch.infer.resize import resize_linear
from densebox_tpu_torch.infer.detector import pyramid_shapes
from densebox_tpu_torch.models import DenseBox, QuantDenseBox, quantize_densebox
from port_bench import harness
from port_bench.reference import compare, detect as ref_detect, model as ref
from port_bench.traffic.scenes import scene_pool
from port_bench.weights import make_weights

HW = (64, 96)


def _cell(name, **infer):
    conf = json.load(open(harness.ROOT / "port_bench" / "configs"
                          / f"{name}.json"))
    c = conf["config"]
    c["model"]["width_mult"] = 0.125
    c["infer"].update(infer)
    return conf


def _inputs(conf, seed, kind, dtype=torch.float32, n=2):
    group = conf["config"]["model"]
    w = make_weights(group, conf["assumed"]["biases"], seed, "cpu", dtype)
    imgs = scene_pool(n, HW, kind, 3, torch.Generator().manual_seed(seed))
    return group, w, imgs


def _live_thresh(maps):
    """A score threshold at the 97th percentile of a map, so that tiny
    random models have candidates."""
    s = maps.get("refined", maps["score"]).flatten()
    return float(torch.quantile(s, 0.97))


@pytest.mark.parametrize("name,kind", [("kitti_vehicle", "vehicles"),
                                       ("malf_face", "faces")])
def test_float_forward_matches_the_port(name, kind):
    conf = _cell(name)
    group, w, imgs = _inputs(conf, 3, kind)
    port = DenseBox(DenseBoxConfig.from_dict(conf["config"]).model,
                    device="cpu")
    port.load_state_dict(w)
    with torch.no_grad():
        want = ref.forward_float(w, group, imgs)
        got = port(imgs)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_int8_chain_codes_equal_the_port_on_its_scales(seed):
    conf = _cell("kitti_vehicle")
    group, w, imgs = _inputs(conf, seed, "vehicles")
    cfg = DenseBoxConfig.from_dict(conf["config"]).model
    sd = quantize_densebox(w, cfg, imgs)
    port = QuantDenseBox(cfg, backend="fused", device="cpu")
    port.load_state_dict(sd)
    mine = ref.calibrate(w, group, imgs)
    # the calibration: every scale within one bfloat16 step (2**-7)
    assert compare.scale_gap(sd, mine) <= 2 ** -7
    # the chain: bit for bit on the port's own scales
    theirs = {n: dict(q, in_scale=sd[f"{n}.in_scale"]) for n, q in
              mine.items()}
    with torch.no_grad():
        got = port(imgs)
        want = ref.forward_int8(theirs, group, imgs)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_int4_chain_is_far_from_int8():
    conf = _cell("kitti_vehicle")
    group, w, imgs = _inputs(conf, 5, "vehicles")
    q8 = ref.calibrate(w, group, imgs)
    q4 = ref.calibrate(w, group, imgs, qmax=7)
    with torch.no_grad():
        a = ref.forward_int8(q8, group, imgs)
        b = ref.forward_int8(q4, group, imgs, qmax=7)
    assert compare.map_gap([b], [a]) > 0.2


def test_pyramid_resize_equals_the_port():
    imgs = scene_pool(2, (120, 160), "faces", 3,
                      torch.Generator().manual_seed(2))
    scales = (0.3536, 0.5, 0.7071, 1.4142)
    assert [tuple(s) for s in ref.pyramid_shapes(120, 160, scales)] == [
        (hs, ws, sx, sy) for hs, ws, sy, sx in pyramid_shapes(120, 160,
                                                              scales)]
    for hs, ws, _, _ in ref.pyramid_shapes(120, 160, scales):
        assert torch.equal(ref.resize(imgs, (hs, ws)),
                           resize_linear(imgs, (hs, ws)))


@pytest.mark.parametrize("name,kind", [("kitti_vehicle", "vehicles"),
                                       ("malf_face", "faces")])
def test_decode_nms_and_landmarks_equal_the_port(name, kind):
    conf = _cell(name, scales=[0.5, 1.0, 1.4142], topk_per_scale=32,
                 pre_nms_topk=48, max_dets=24, lm_topk=8)
    group, w, imgs = _inputs(conf, 6, kind)
    cfg = DenseBoxConfig.from_dict(conf["config"])
    port = DenseBox(cfg.model, device="cpu")
    port.load_state_dict(w)
    with torch.no_grad():
        thresh = _live_thresh(port(imgs))
        conf["config"]["infer"]["score_thresh"] = thresh
        cfg = DenseBoxConfig.from_dict(conf["config"])
        levels = pyramid_maps(port, imgs, cfg.infer)
        got = detect_from_maps(levels, HW, cfg.infer, cfg.label)
        want = ref_detect.detect(levels, HW, conf["config"]["infer"],
                                 conf["config"]["label"])
    assert int(want["valid"].sum()) > 0
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    pairs = [(compare.answer(got, i), compare.answer(want, i))
             for i in range(imgs.shape[0])]
    assert compare.det_gap(pairs) == 0.0


def test_det_gap_sees_a_moved_box_and_a_lost_detection():
    a = {"boxes": np.zeros((2, 4), np.float32),
         "scores": np.ones(2, np.float32)}
    moved = dict(a, boxes=a["boxes"] + np.float32(0.25))
    lost = {"boxes": a["boxes"][:1], "scores": a["scores"][:1]}
    assert compare.det_gap([(a, a)]) == 0.0
    assert compare.det_gap([(moved, a)]) == 0.25
    assert compare.det_gap([(lost, a)]) == compare.SETS_DIFFER


def test_fp8_control_is_far_from_f32():
    conf = _cell("malf_face")
    group, w, imgs = _inputs(conf, 7, "faces", dtype=torch.bfloat16)
    with torch.no_grad():
        f32 = ref.forward_float(w, group, imgs)
        fp8 = ref.forward_float(w, group, imgs, fp8=True)
        port = DenseBox(dataclasses.replace(
            DenseBoxConfig.from_dict(conf["config"]).model,
            compute_dtype="bfloat16", param_dtype="bfloat16"), device="cpu")
        port.load_state_dict(w)
        bf16 = port(imgs)
    assert compare.map_gap([fp8], [f32]) > 3 * compare.map_gap([bf16], [f32])
