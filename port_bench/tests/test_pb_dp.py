"""The data-parallel train cell at the tiny shapes of
``tests/test_torch_parallel.py`` (width 1/8, 64-px patches) on the CPU:
four ranks over gloo, spawned by the cell's own driver, whose comparison
with the reference on the global batch reads correct on a sound run and
not correct under each fault of the timed path. Each fault is installed
in every rank by ``spec["rank_hook"]``, a function of this module that the
spawned ranks import by name. The ranks join with the driver's timeout.

The harness's line of a one-card outcome is the one it has always built;
a four-card outcome reports its count, the means of its cards' traces and
the breakdown of the busiest, and the train readers take the worst card."""

from unittest import mock

import pytest
import torch

from port_bench import harness
from port_bench.trace import Summary

CELL = "kitti_train_dp4"
TINY = {"config": {"config": {"model": {"width_mult": 0.125},
                              "label": {"patch_size": 64,
                                        "std_height_px": 20.0},
                              "train": {"batch_size": 8}}},
        "traffic": {"canvas": 128, "max_boxes": 4, "pool_batches": 3,
                    "check_every": 2, "heights": [12.0, 40.0]}}


def _run(hook=None, seed=2**31 + 29):
    over = dict(TINY, spec={"rank_hook": hook})
    return harness.run_cell(CELL, seed, 0.5, False, torch.device("cpu"),
                            overrides=over)


# faults, installed in a rank before it builds anything

def _shard():
    from densebox_tpu_torch.parallel import mesh
    return mesh._StepShard


def no_reduce(rank):
    """The exchange between the cards left out: each rank steps on its own
    gradient."""
    mock.patch.object(_shard(), "reduce_grads", lambda self, g: None).start()


def averaged(rank):
    """The gradients averaged over the ranks, where the loss's global
    normalisers want them summed. It shows only where the global
    gradient's norm lies under the clip times the ranks (so at this seed):
    above that, the clip to a fixed norm undoes the division."""
    real = _shard().reduce_grads

    def mean(self, grads):
        real(self, grads)
        torch._foreach_div_(grads, float(self.n_data))
    mock.patch.object(_shard(), "reduce_grads", mean).start()


def shifted_shard(rank):
    """Rank 1 keeps the draws of the rows one past its own."""
    if rank != 1:
        return
    real = _shard().local_draws

    def roll(d):
        return ({k: roll(v) for k, v in d.items()} if isinstance(d, dict)
                else d.roll(-1, 0))

    mock.patch.object(_shard(), "local_draws",
                      lambda self, draws, b: real(self, roll(draws), b)
                      ).start()


def nudged(rank):
    """The last rank's parameters pushed off the others' in the window
    (after the compared steps): one gradient leaf shifted there."""
    if rank != 3:
        return
    real = _shard().reduce_grads
    calls = [0]

    def nudge(self, grads):
        real(self, grads)
        calls[0] += 1
        if calls[0] > 3:
            grads[0].add_(1e-3)
    mock.patch.object(_shard(), "reduce_grads", nudge).start()


def frozen(rank):
    """A step that returns its state unchanged."""
    from densebox_tpu_torch.train import loop

    mock.patch.object(loop, "sgd_update",
                      lambda params, grads, *a, norm=loop.global_norm, **k:
                      norm(grads)).start()


def half_batch(rank):
    """The loss's mean taken over the first half of each rank's rows."""
    from densebox_tpu_torch.train import loop

    real = loop.densebox_loss

    def half(outputs, gts, rnd, cfg, rnd_refined=None, total=None):
        h = rnd.shape[0] // 2
        return real({k: v[:h] for k, v in outputs.items()},
                    {k: v[:h] for k, v in gts.items()}, rnd[:h], cfg,
                    None if rnd_refined is None else rnd_refined[:h], total)
    mock.patch.object(loop, "densebox_loss", half).start()


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["rank_gap"]["value"] == 0.0
    assert line["device"]["count"] == 4
    assert line["attempted"] > 0 and line["attempted"] % 8 == 0


@pytest.mark.parametrize("fault, caught", [
    (no_reduce, "grad_gap"), (averaged, "grad_gap"),
    (shifted_shard, "loss_gap"), (nudged, "rank_gap"),
    (frozen, "update_gap"), (half_batch, "loss_gap")],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_is_not_correct(fault, caught):
    line = _run(fault)
    assert line["correct"] is False
    chk = line["checks"][caught]
    assert chk["value"] > chk["limit"], line["checks"]


def _summary(busy_ns, window_ns=10**9):
    return Summary([(0, busy_ns, "k")], [(0, window_ns, "host")],
                   (0, window_ns))


def _outcome(**kw):
    base = dict(attempted=64, failed=0,
                end_to_end={"train_images_per_s": 300.0, "setup_s": 12.0},
                ctx={"steps": 2, "images": 64, "window_s": 1.0,
                     "least_s_per_step": 0.05},
                numbers={"loss_gap": 1e-6, "grad_gap": 1e-6,
                         "update_gap": 1e-5},
                memory_peak_bytes=6_140_000_000,
                device_kind="NVIDIA H100 80GB HBM3")
    base.update(kw)
    return harness.Outcome(**base)


def test_a_one_card_line_is_as_it_was():
    c = harness.cell("kitti_train")
    line = harness.result_line(c, _outcome(), False)
    assert line == {
        "correct": True, "attempted": 64, "failed": 0,
        "metrics": {"train_images_per_s": {"value": 300.0,
                                           "unit": "images/s"},
                    "setup_s": {"value": 12.0, "unit": "s"}},
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1, "memory_peak_bytes": 6_140_000_000},
        "checks": {k: {"value": v, "limit": c.spec["limits"][k]}
                   for k, v in _outcome().numbers.items()}}
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    traced = harness.result_line(
        c, _outcome(traces=[_summary(990_000_000)]), True)
    assert traced["device"]["busy_s"] == 0.99
    assert traced["device"]["window_s"] == 1.0
    assert traced["metrics"]["device_idle_share.train"]["value"] == \
        pytest.approx(1.0)
    assert list(traced)[-2:] == ["breakdown", "checks"]


def test_a_four_card_line_reports_them_and_the_busiest():
    c = harness.cell(CELL)
    traces = [_summary(n) for n in (900_000_000, 950_000_000, 930_000_000,
                                    910_000_000)]
    res = _outcome(memory_peak_bytes=6_300_000_000, count=4,
                   numbers={"rank_gap": 0.0}, traces=traces,
                   ctx={"steps": 2, "images": 64, "window_s": 1.0,
                        "least_s_per_step": 0.05})
    line = harness.result_line(c, res, True)
    dev = line["device"]
    assert dev["count"] == 4 and dev["memory_peak_bytes"] == 6_300_000_000
    assert dev["busy_s"] == pytest.approx(0.9225)
    assert dev["window_s"] == 1.0
    assert line["breakdown"] == traces[1].breakdown()
    m = line["metrics"]
    assert m["device_idle_share.train"]["value"] == pytest.approx(10.0)
    assert m["mfu.train"]["value"] == pytest.approx(10.0)
    assert "allreduce_ms_per_step.train_dp" not in m    # no NCCL kernel
    assert line["correct"] is True


def test_the_nccl_readers_take_the_worst_rank():
    win = (0, 10**9)
    a = Summary([(0, 400, "conv"), (300, 500, "ncclDevKernel_AllReduce"),
                 (600, 700, "ncclDevKernel_AllReduce")], [], win)
    b = Summary([(0, 100, "conv"), (100, 400, "ncclKernel_AllReduce")], [],
                win)
    assert a.alone_s(lambda n: "nccl" in n) == pytest.approx(200e-9)
    assert b.alone_s(lambda n: "nccl" in n) == pytest.approx(300e-9)
    ctx = {"steps": 2, "traces": [a, b]}
    ms = harness.reader("allreduce_ms_per_step.train_dp")(ctx)
    assert ms == pytest.approx(300e-9 * 1e3 / 2)
    share = harness.reader("allreduce_exposed_share.train_dp")(ctx)
    assert share == pytest.approx(100.0 * 300e-9)
