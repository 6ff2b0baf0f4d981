"""The benchmark's readers of DetectServer's counters and spans
(``port_bench/metrics/*.serve.py``) on hand-made inputs: a
``port_bench.trace.Summary`` with placed device intervals and spans placed
in the program's ring, and the counters of a real server on the CPU.
"""

import collections

import numpy as np
import pytest
import torch

from densebox_tpu_torch import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.models import DenseBox, init_params
from densebox_tpu_torch.serve import DetectServer
from densebox_tpu_torch.utils import logging as logmod
from port_bench import harness
from port_bench.trace import Summary

COUNTERS = ("queue_wait_ms.serve", "batch_window_ms.serve",
            "worker_host_ms.serve")
IDLE = ("idle_waiting_share.serve", "idle_unattributed_share.serve")
M = 1_000_000                           # ns in a ms


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    monkeypatch.setattr(logmod, "_RING",
                        collections.deque(maxlen=logmod.SPAN_RING))
    monkeypatch.setattr(logmod, "_DROPPED", [0, 0])
    return logmod._RING


def _read(name, **ctx):
    return harness.reader(name)(ctx)


def test_every_new_reader_is_a_per_layer_metric_of_the_serve_cells():
    by_name = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in COUNTERS + IDLE:
        m = by_name[name]
        assert m["moves"] == "latency_p95_ms" and m["better"] == "lower"
        assert m["workloads"] == ["malf_bf16_serve", "kitti_int8_serve"]
        assert m["unit"] == ("%" if name in IDLE else "ms")
        assert callable(harness.reader(name))
    assert "queue_wait_ms.serve" in [
        m["name"] for m in harness.cell("kitti_int8_serve").per_layer]


STATS = {"requests": 40, "device_calls": 8, "queue_wait_s": 1.2,
         "window_s": 0.112, "fill_s": 0.008, "scatter_s": 0.004,
         "detect_s": 0.4, "fetch_s": 0.001, "idle_s": 0.3,
         "letterbox_s": 0.02, "closed_full": 1, "closed_deadline": 7,
         "padded_slots": 24}


@pytest.mark.parametrize("name, want", [
    ("queue_wait_ms.serve", 30.0),           # 1.2 s / 40 requests
    ("batch_window_ms.serve", 14.0),         # 0.112 s / 8 calls
    ("worker_host_ms.serve", 1.5),           # (0.008 + 0.004) s / 8 calls
])
def test_counter_readers(name, want):
    assert _read(name, stats=STATS) == pytest.approx(want)
    # a program without the counters, or a window without a call
    assert _read(name, stats={"requests": 5, "device_calls": 1}) is None
    assert _read(name, stats=dict(STATS, requests=0, device_calls=0)) is None


def test_counter_readers_on_a_served_window():
    cfg = ModelCfg(width_mult=0.125)
    model = DenseBox(cfg, device="cpu")
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    infer = InferCfg(scales=(1.0,), score_thresh=-1e9, topk_per_scale=8,
                     pre_nms_topk=8, max_dets=4)
    server = DetectServer(model, infer, LabelCfg(), canvas_hw=(64, 96),
                          max_batch=2, batch_window_ms=5.0, device="cpu")
    try:
        before = dict(server.stats)
        for seed in range(3):
            server.submit(np.random.RandomState(seed).rand(50, 70, 3)
                          .astype(np.float32))
    finally:
        server.close()
    stats = {k: server.stats[k] - before[k] for k in before}
    window = _read("batch_window_ms.serve", stats=stats)
    assert 4.0 <= window <= 1000.0   # one request a call: the whole window
    assert _read("queue_wait_ms.serve", stats=stats) >= 0.0
    assert _read("worker_host_ms.serve", stats=stats) > 0.0


# A window of 1 ms from t = 1 ms, the card busy 1.1-1.3 and 1.5-1.6 ms:
# idle 1.0-1.1, 1.3-1.5 and 1.6-2.0 ms, 0.7 ms in all.
WINDOW = (1 * M, 2 * M)
DEVICE = [(1.1, 1.3, "k1"), (1.5, 1.6, "k2")]
SPANS = [  # (name, start ms, end ms, id, parent)
    ("serve.idle", 0.9, 1.05, 1, None),      # waiting 0.05 of gap 1
    ("serve.window", 1.05, 1.08, 1, None),   # waiting 0.03
    ("serve.fill", 1.08, 1.1, 1, None),      # host 0.02
    ("serve.detect", 1.1, 1.35, 1, None),    # host 0.05 of gap 2
    ("serve.fetch", 1.35, 1.36, 1, None),    # host 0.01
    ("serve.scatter", 1.36, 1.4, 1, None),   # host 0.04; 1.4-1.45 bare
    ("serve.idle", 1.45, 1.6, 2, None),      # waiting 0.05
    ("serve.window", 1.6, 1.7, 2, None),     # waiting 0.1; 1.7-2.0 bare
    ("serve.queue", 1.6, 2.0, 3, 2),         # a request's: not the worker's
    ("serve.letterbox", 1.4, 1.45, 3, 2),
    ("serve.idle", 2.5, 3.0, 4, None),       # after the window
]


def _summary(device=DEVICE, window=WINDOW):
    return Summary([(int(s * M), int(e * M), n) for s, e, n in device], [],
                   window)


def _place(spans=SPANS):
    for name, s, e, sid, parent in spans:
        logmod.record_span(name, int(s * M), int(e * M), sid, parent)


def test_idle_readers_split_the_idle_time():
    _place()
    waiting = _read("idle_waiting_share.serve", trace=_summary())
    bare = _read("idle_unattributed_share.serve", trace=_summary())
    assert waiting == pytest.approx(100 * 0.23 / 0.7)
    assert bare == pytest.approx(100 * 0.35 / 0.7)
    host = 100 * 0.12 / 0.7          # under fill, detect, fetch, scatter
    assert waiting + bare + host == pytest.approx(100.0)


@pytest.mark.parametrize("name", IDLE)
def test_idle_readers_read_nothing_without_what_they_read(name, monkeypatch):
    assert _read(name, trace=None) is None
    assert _read(name, trace=_summary()) is None          # no spans
    _place()
    assert _read(name, trace=_summary(device=[])) is None
    assert _read(name, trace=_summary()) is not None
    # the ring lost spans that ended before the window: still read
    monkeypatch.setattr(logmod, "_DROPPED", [3, int(0.5 * M)])
    assert _read(name, trace=_summary()) is not None
    # ... and one that ended inside it: nothing
    monkeypatch.setattr(logmod, "_DROPPED", [4, int(1.2 * M)])
    assert _read(name, trace=_summary()) is None


@pytest.mark.parametrize("name", IDLE)
def test_idle_readers_after_a_full_ring(name, monkeypatch):
    monkeypatch.setattr(logmod, "_RING", collections.deque(maxlen=4))
    _place()                          # 11 spans into 4 slots
    assert logmod.spans_dropped() == 7
    assert _read(name, trace=_summary()) is None


@pytest.mark.parametrize("name", IDLE)
def test_idle_readers_of_a_program_without_the_ring(name, monkeypatch):
    monkeypatch.delattr(logmod, "spans_between")
    _place()
    assert _read(name, trace=_summary()) is None
