"""The comparison that decides ``correct`` has to fail its control and the
faults a cell can have. Here at a tiny size on the CPU (the port's plain
kernel versions), with the cells' own limits; on the card the control runs
as ``python3 -m port_bench.control``.

Each fault test skips the harness's look for a card, drives the rest of a
run (``harness.run_cell``) with the timed path broken underneath, and sees
``correct`` come out false, where the same run unbroken comes out true."""

from unittest import mock

import pytest
import torch

from port_bench import control, harness

CELLS = ["kitti_int8_offline", "malf_bf16_serve", "kitti_int8_serve"]

# width 1/8, a 64 x 96 canvas, two scales, every candidate valid (random
# tiny models score low), every image of a call compared
TINY = {"config": {"config": {"model": {"width_mult": 0.125},
                              "infer": {"scales": [0.5, 1.0],
                                        "score_thresh": -1e9,
                                        "topk_per_scale": 32,
                                        "pre_nms_topk": 48, "max_dets": 16,
                                        "lm_topk": 8}}},
        "traffic": {"canvas": [64, 96], "batch": 4, "pool": 8, "objects": 2,
                    "rate_per_s": 20.0, "senders": 4, "warmup_requests": 2},
        "spec": {"compare_images": 4, "compare_scenes": 3}}


def _run(name, seed=2**31 + 9):
    return harness.run_cell(name, seed, 1.5, False, torch.device("cpu"),
                            overrides=TINY)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    res = control.run_control(name, 2**31 + 3, "cpu", overrides=TINY)
    assert res["correct"] is False, res


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


def _nudged_nms(real):
    """NMS whose kept boxes come out a pixel to the right: an answer
    altered where it is produced."""
    def nms(*args, **kwargs):
        out = list(real(*args, **kwargs))
        out[0] = out[0] + torch.tensor([1.0, 0.0, 1.0, 0.0])
        return tuple(out)
    return nms


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_not_correct(name):
    from densebox_tpu_torch.infer import detector

    with mock.patch.object(detector, "nms", _nudged_nms(detector.nms)):
        line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["det_gap"]["value"] >= 1.0


@pytest.mark.parametrize("name", CELLS)
def test_maps_of_another_slot_are_not_correct(name):
    """The model hands each image the maps of the image in the slot before
    it (a batch mix-up where the maps are produced)."""
    from densebox_tpu_torch.models import densebox, quant

    def rolled(real):
        def forward(self, images, *args, **kwargs):
            out = real(self, images, *args, **kwargs)
            return {k: v.roll(1, 0) for k, v in out.items()}
        return forward

    with mock.patch.object(densebox.DenseBox, "forward",
                           rolled(densebox.DenseBox.forward)), \
            mock.patch.object(quant.QuantDenseBox, "forward",
                              rolled(quant.QuantDenseBox.forward)):
        line = _run(name)
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > line["checks"]["map_gap"][
        "limit"]


def test_half_the_batch_left_out_is_not_correct():
    """detect_batch computes the first half of the batch twice over and
    never the second half's images."""
    import densebox_tpu_torch.infer as infer

    real = infer.detect_batch

    def half(model, images, infer_cfg, label_cfg):
        h = images.shape[0] // 2
        return real(model, torch.cat([images[:h], images[:h]]), infer_cfg,
                    label_cfg)

    with mock.patch.object(infer, "detect_batch", half):
        line = _run("kitti_int8_offline")
    assert line["correct"] is False
    assert line["checks"]["map_gap"]["value"] > line["checks"]["map_gap"][
        "limit"]
