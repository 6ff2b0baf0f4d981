"""Operation and byte counts against hand counts."""

import json

import pytest

from port_bench import harness, roofline
from port_bench.reference.model import conv_specs, pyramid_shapes


def _model(name):
    conf = json.load(open(harness.ROOT / "port_bench" / "configs"
                          / f"{name}.json"))
    return conf["config"]["model"], conf["config"]["infer"]["scales"]


def test_tensor_core_qconv_launch_by_hand():
    # conv2_1 of one 480 x 640 image: 240 x 320, 64 -> 128, 3 x 3, int8 out
    # (Cin a multiple of 16: qconv_int8's mma variant)
    l = roofline.Launch("conv2_1", 1, 240, 320, 64, 128, 3, 1)
    assert roofline.conv_ops(1, 240, 320, 64, 128, 3) == 11_324_620_800
    assert roofline.qconv_bytes(l) == 76_800 * 192 + 128 * 9 * 64 + 12 * 128
    t, by = roofline.bound_s(11_324_620_800, roofline.qconv_bytes(l), "int8")
    assert by == "operations" and t == pytest.approx(11_324_620_800 / 1979e12)


def test_cuda_core_qconv_launch_by_hand():
    # conv1_1: Cin 3 (qconv_int8's dp4a variant), 480 x 640, 3 -> 64
    l = roofline.Launch("conv1_1", 1, 480, 640, 3, 64, 3, 1)
    assert roofline.conv_ops(1, 480, 640, 3, 64, 3) == 1_061_683_200
    assert roofline.qconv_bytes(l) == 20_584_896
    t, by = roofline.bound_s(1_061_683_200, roofline.qconv_bytes(l), "int8")
    assert by == "bytes" and t == pytest.approx(20_584_896 / 3.35e12)


def test_bf16_conv_least_time_by_hand():
    # conv4_2 of malf_face at scale 1: 60 x 80, 512 -> 512, 3 x 3, B=8
    ops = roofline.conv_ops(8, 60, 80, 512, 512, 3)
    assert ops == 2 * 8 * 4800 * 512 * 512 * 9
    assert roofline.least_s({"bf16": ops}) == pytest.approx(ops / 989e12)


def test_f32_peak_is_the_cuda_cores_rate():
    assert roofline.least_s({"f32": 67e12}) == pytest.approx(1.0)


def test_pyramid_shapes_round_up_to_multiples_of_8():
    assert [s[:2] for s in pyramid_shapes(480, 640,
                                          (0.5, 0.7071, 1.0, 1.4142))] == [
        (240, 320), (344, 456), (480, 640), (680, 912)]
    assert [s[:2] for s in pyramid_shapes(480, 640, (0.3536,))] == [
        (176, 232)]
    hs, ws, sx, sy = pyramid_shapes(480, 640, (0.7071,))[0]
    assert (sx, sy) == (456 / 640, 344 / 480)


def test_the_paper_trunk_at_one_scale_by_hand():
    model, _ = _model("kitti_vehicle")
    launches = roofline.level_convs(model, 1, 480, 640)
    ops = {l.name: roofline.conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k)
           for l in launches}
    px = 480 * 640
    want = (2 * px * 9 * (3 * 64 + 64 * 64)
            + 2 * px // 4 * 9 * (64 * 128 + 128 * 128)
            + 2 * px // 16 * 9 * (128 * 256 + 3 * 256 * 256)
            + 2 * px // 64 * 9 * (256 * 512 + 3 * 512 * 512))
    assert sum(v for k, v in ops.items() if k.startswith("conv")) == want
    # heads at stride 4 over f3 ++ up(f4): 768 -> 512 -> 1 and -> 4
    assert ops["det.det_conv1"] == 2 * px // 16 * 768 * 512
    assert ops["loc.loc_conv2"] == 2 * px // 16 * 512 * 4
    out = {l.name: l.out_bytes for l in launches}
    assert out["conv4_4"] == out["det.det_conv2"] == 4
    assert out["conv3_4"] == out["det.det_conv1"] == 1


def test_malf_has_the_landmark_and_refine_convs():
    model, _ = _model("malf_face")
    names = [c.name for c in conv_specs(model)]
    assert names[-3:] == ["refine_conv1", "refine_conv2", "refine_out"]
    assert "lm.lm_conv2" in names and len(names) == 12 + 6 + 3


def test_detect_products_of_a_call():
    model, scales = _model("kitti_vehicle")
    ops = roofline.detect_products(model, 64, (480, 640), scales, "int8")
    one = sum(roofline.conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k)
              for l in roofline.detect_launches(model, 64, (480, 640),
                                                scales))
    assert ops["int8"] == one
    # the pyramid holds 0.25 + 0.5 + 1 + 2 times the pixels of scale 1
    base = sum(roofline.conv_ops(l.b, l.h, l.w, l.cin, l.cout, l.k)
               for l in roofline.level_convs(model, 64, 480, 640))
    assert 3.7 < one / base < 3.9
    assert 0 < ops["f32"] < 0.01 * one


def test_serve_mfu_counts_answered_requests_not_padded_slots():
    # two calls of 0.1 s that answered 5 and 3 requests (padded to 8 each):
    # 8 images of 1 ms least time over 0.2 s of calls
    read = harness.reader("mfu.serve")
    ctx = {"spans": [(0.0, 0.1), (1.0, 1.1)], "least_s_per_image": 1e-3,
           "stats": {"requests": 8, "device_calls": 2}}
    assert read(ctx) == pytest.approx(4.0)
    assert read(dict(ctx, spans=[])) is None


def test_a_detect_call_is_linear_in_its_batch():
    model, scales = _model("kitti_vehicle")
    one = roofline.detect_products(model, 1, (480, 640), scales, "int8")
    eight = roofline.detect_products(model, 8, (480, 640), scales, "int8")
    assert roofline.least_s(eight) == pytest.approx(8 * roofline.least_s(one))
