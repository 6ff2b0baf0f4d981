"""The train cell at a tiny size on the CPU: the reference follows the
port's canvas step, and the comparison sees a step that leaves its state
unchanged and a step that takes its mean over half of the batch. The
control (TF32) needs the card's tensor cores: it runs there."""

from unittest import mock

import pytest
import torch

from port_bench import control, harness

TINY = {"config": {"config": {"model": {"width_mult": 0.125},
                              "label": {"patch_size": 64,
                                        "std_height_px": 20.0}}},
        "traffic": {"canvas": 128, "batch": 4, "max_boxes": 4,
                    "pool_batches": 3, "heights": [12.0, 40.0]}}


def _run(seed=2**31 + 17):
    return harness.run_cell("kitti_train", seed, 1.0, False,
                            torch.device("cpu"), overrides=TINY)


def test_the_reference_follows_the_port_step():
    c = harness.cell("kitti_train")
    c.config = harness.merged(c.config, TINY["config"])
    c.traffic = harness.merged(c.traffic, TINY["traffic"])
    res = harness.driver("train").run(c, 11, 0.5, False, torch.device("cpu"))
    assert max(res.numbers.values()) < 1e-4, res.numbers
    assert res.ctx["readings"]["nought_leaves"] == []


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct():
    from densebox_tpu_torch.train import loop

    def frozen(params, grads, momentum, cfg, step, norm=loop.global_norm):
        return norm(grads)

    with mock.patch.object(loop, "sgd_update", frozen):
        line = _run()
    assert line["correct"] is False
    assert line["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct():
    """The loss's mean taken over the first half of the batch alone."""
    from densebox_tpu_torch.train import loop

    real = loop.densebox_loss

    def half(outputs, gts, rnd, cfg, rnd_refined=None, total=None):
        h = rnd.shape[0] // 2
        return real({k: v[:h] for k, v in outputs.items()},
                    {k: v[:h] for k, v in gts.items()}, rnd[:h], cfg,
                    None if rnd_refined is None else rnd_refined[:h], total)

    with mock.patch.object(loop, "densebox_loss", half):
        line = _run()
    assert line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"][
        "limit"]


@pytest.mark.gpu
def test_the_tf32_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only on its tensor cores")
    res = control.run_control("kitti_train", 2**31 + 23, "cuda")
    assert res["correct"] is False, res
