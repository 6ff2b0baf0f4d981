"""The car detector with 8 landmarks and the refine branch
(``port_bench/configs/kitti_vehicle_lm8.json``) on the CPU.

* ``QuantDenseBox`` (int8, ``fused``) at width 0.125 on a KITTI-shaped
  canvas, calibrated by ``quantize_densebox``, against the benchmark's
  plain reference (``port_bench/reference``) on the benchmark's seeded
  weights: the int8 scales, the maps ``score``, ``loc``, ``lm`` and
  ``refined`` at every pyramid scale, then ``detect_batch``'s boxes, scores
  and landmark points against the reference's decode of the same maps.
  Bar: equality (the CPU runs every kernel's plain version, whose integer
  sums and separately rounded float operations the reference repeats).
* The cell ``kitti_lm8_int8_offline`` reports ``images_per_s``, ``setup_s``,
  the offline readers and the two readers of the program's spans.
* Those two readers on a hand-made trace whose launches and kernels are
  known, and ``detect_batch``'s spans: the pyramid, the boxes, the
  landmarks and the refine branch of each scale under one call's id.
"""

import collections
import dataclasses

import pytest
import torch

from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.infer.detector import pyramid_maps
from densebox_tpu_torch.models import DenseBox, init_params
from densebox_tpu_torch.utils import logging as logmod
from port_bench import harness, program
from port_bench.reference import compare, detect as ref_detect, model as ref
from port_bench.trace import Summary
from port_bench.traffic.scenes import scenes
from port_bench.weights import make_weights

CELL = "kitti_lm8_int8_offline"
HW = (48, 160)                      # KITTI's aspect, a multiple of 8
# width 0.125, and a score threshold that keeps many detections of
# random weights, so that the landmark decode has work
SMALL = {"config": {"model": {"width_mult": 0.125},
                    "infer": {"score_thresh": 0.0}}}
READERS = ("lm_decode_ms_per_image.offline", "refine_ms_per_image.offline")
M = 1_000_000                       # ns in a ms


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    monkeypatch.setattr(logmod, "_RING",
                        collections.deque(maxlen=logmod.SPAN_RING))
    monkeypatch.setattr(logmod, "_DROPPED", [0, 0])
    return logmod._RING


@pytest.fixture(scope="module")
def case():
    c = harness.cell(CELL)
    c.config = harness.merged(c.config, SMALL)
    cfg = program.config(c)
    group = program.model_group(c)
    # the loc head's bias makes boxes of 5 map pixels, inside the peak
    # search's window (the smallest map's 6 rows here; 32 on the cell's
    # canvas, whose bias 1.0 makes boxes of 25)
    biases = dict(c.config["assumed"]["biases"], **{"loc.loc_conv2": 0.2})
    weights = make_weights(group, biases, 2**31 + 21, "cpu", torch.float32)
    images = scenes(4, HW, "vehicles", 3,
                    torch.Generator().manual_seed(7))[0]
    model = program.detector(c, cfg, weights, images, "cpu")
    return c, cfg, group, weights, images, model


def test_the_configuration_is_kitti_vehicle_with_8_landmarks_and_refine():
    conf = harness.cell(CELL).config
    kitti = harness.cell("kitti_int8_offline").config
    model = dict(kitti["config"]["model"], num_landmarks=8, use_refine=True)
    assert conf["config"] == dict(kitti["config"], model=model)
    assert conf["reduced"] == []
    assert conf["assumed"]["biases"] == {"det.det_conv2": 0.0,
                                         "loc.loc_conv2": 1.0,
                                         "refine_out": 0.0}


def test_int8_maps_and_answers_equal_the_reference(case):
    c, cfg, group, weights, images, model = case
    conf = c.config["config"]
    x = images[:2]
    q = ref.calibrate({k: v.float() for k, v in weights.items()}, group,
                      images)
    assert compare.scale_gap(program.scales_of(model), q) == 0.0
    with torch.inference_mode():
        mine = pyramid_maps(model, x, cfg.infer)
        dets = detect_batch(model, x, cfg.infer, cfg.label)
    want = ref.pyramid(lambda t: ref.forward_int8(q, group, t), x,
                       conf["infer"]["scales"])
    assert len(mine) == len(want) == 4
    for (m, xy), (w, wxy) in zip(mine, want):
        assert set(m) == {"score", "loc", "lm", "refined"}
        assert m["lm"].shape[-1] == 8 and xy == pytest.approx(wxy)
        gaps = compare.map_gaps([m], [w])
        assert all(g == 0.0 for g in gaps.values()), gaps
    from_maps = ref_detect.detect(mine, HW, conf["infer"], conf["label"])
    assert dets["lm_points"].shape == (2, conf["infer"]["max_dets"], 8, 2)
    pairs = [(compare.answer(dets, j), compare.answer(from_maps, j))
             for j in range(2)]
    assert compare.det_gap(pairs) == 0.0
    # the decode had work: detections, and landmarks found at a peak
    assert int(dets["valid"].sum()) >= 10
    assert int(dets["lm_valid"].sum()) >= 10


def test_the_cell_reports_its_metrics():
    c = harness.cell(CELL)
    assert {m["name"] for m in c.end_to_end} == {"images_per_s", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "elementwise_ms_per_image.offline", "qconv_int8_roofline.offline",
        "mfu.offline", "device_idle_share.offline", *READERS}
    by_name = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in READERS:
        m = by_name[name]
        assert m["workloads"] == [CELL] and m["moves"] == "images_per_s"
        assert m["source"] == "device_trace" and m["unit"] == "ms/image"
    assert c.traffic["canvas"] == [384, 1248] and c.traffic["batch"] == 64


def _trace():
    """Six launches on the host, at 10, 20, ... 60 ms, among host work that
    launches nothing; the card runs them later, in order, for 1, 2, ... 6
    ms."""
    host = [(k * 10 * M, k * 10 * M + M // 2, name) for k, name in enumerate(
        ("cudaLaunchKernel", "cudaMemcpyAsync", "cuLaunchKernel",
         "cudaLaunchKernelExC", "cudaMemsetAsync", "cudaLaunchKernel"),
        start=1)]
    host += [(12 * M, 13 * M, "aten::add"),
             (33 * M, 34 * M, "cudaStreamSynchronize"),
             (45 * M, 46 * M, "cudaEventRecord")]
    device, t = [], 100 * M
    for k in range(1, 7):
        device.append((t, t + k * M, f"kernel_{k}"))
        t += k * M + M
    return Summary(device, host, (0, 200 * M))


@pytest.mark.parametrize("name, spans, want", [
    # launches 2 and 3 (ops of 2 and 3 ms) over 10 images
    ("lm_decode_ms_per_image.offline",
     [("detect.landmarks", 15, 35), ("detect.boxes", 5, 15)], 0.5),
    # two spans: launch 4, and launches 5 and 6
    ("refine_ms_per_image.offline",
     [("model.refine", 38, 42), ("model.refine", 48, 61)], 1.5),
])
def test_span_readers_tie_launches_to_kernels(ring, name, spans, want):
    for n, s, e in spans:
        logmod.record_span(n, s * M, e * M, None, 1)
    read = harness.reader(name)
    assert read({"trace": _trace(), "images": 10}) == pytest.approx(want)
    # without a trace, without images, a device op no launch accounts for
    assert read({"trace": None, "images": 10}) is None
    assert read({"trace": _trace(), "images": 0}) is None
    tr = _trace()
    tr.device.append((190 * M, 191 * M, "kernel_7"))
    assert read({"trace": tr, "images": 10}) is None


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_nothing_without_their_spans(ring, name):
    logmod.record_span("serve.detect", 0, 150 * M, 3, None)
    assert harness.reader(name)({"trace": _trace(), "images": 10}) is None
    # a ring that lost spans of the window
    logmod.record_span("detect.landmarks", 15 * M, 35 * M, None, 1)
    logmod.record_span("model.refine", 15 * M, 35 * M, None, 1)
    logmod._DROPPED[:] = [1, 5 * M]
    assert harness.reader(name)({"trace": _trace(), "images": 10}) is None


def test_detect_batch_records_its_stages_under_one_call(ring, case):
    c, cfg, _, _, images, model = case
    with torch.inference_mode():
        for _ in range(2):
            detect_batch(model, images[:2], cfg.infer, cfg.label)
    spans = list(ring)
    parents = sorted({p for *_, p in spans})
    assert len(parents) == 2 and None not in parents
    for p in parents:
        mine = [s for s in spans if s[4] == p]
        names = collections.Counter(s[0] for s in mine)
        assert names == {"detect.pyramid": 1, "detect.boxes": 1,
                         "detect.landmarks": 1, "model.refine": 4}
        (_, lo, hi, _, _), = [s for s in mine if s[0] == "detect.pyramid"]
        assert all(lo <= s[1] <= s[2] <= hi for s in mine
                   if s[0] == "model.refine")
        assert all(s[1] <= s[2] for s in mine)


def test_the_float_model_records_its_refine_branch(ring):
    cfg = dataclasses.replace(program.config(harness.cell(CELL)).model,
                              width_mult=0.125)
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(1)))
    with logmod.spans_under(41), torch.inference_mode():
        out = model(torch.rand(1, 32, 64, 3))
    assert out["refined"].shape == (1, 8, 16, 1)
    assert [(s[0], s[4]) for s in ring] == [("model.refine", 41)]
