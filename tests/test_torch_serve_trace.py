"""DetectServer's spans and counters (``serve.py``) and the span ring they
go to (``utils/logging.py``), on the CPU at a tiny size: ``stats`` stays a
dict of flat numbers that add up, every device call and request leaves
its spans in order (and its detect call its stages), warm-up leaves none
of the server's, the ring stays bounded and
counts what it drops, its clock is the profiler's, and nothing of the
detect path adds a profiler annotation.
"""

import collections
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from densebox_tpu_torch import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.infer import detect_batch
from densebox_tpu_torch.models import DenseBox, init_params
from densebox_tpu_torch.serve import DetectServer
from densebox_tpu_torch.utils import logging as logmod

INFER = InferCfg(scales=(0.5, 1.0), score_thresh=-1e9, topk_per_scale=16,
                 pre_nms_topk=24, max_dets=8)
CANVAS = (64, 96)
CALL_STAGES = ("serve.idle", "serve.window", "serve.fill", "serve.detect",
               "serve.fetch", "serve.scatter")


@pytest.fixture(scope="module")
def model():
    cfg = ModelCfg(width_mult=0.125)
    m = DenseBox(cfg, device="cpu")
    m.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0)))
    return m.eval()


@pytest.fixture(autouse=True)
def ring(monkeypatch):
    """A fresh ring for each test (the real one is process-wide)."""
    monkeypatch.setattr(logmod, "_RING",
                        collections.deque(maxlen=logmod.SPAN_RING))
    monkeypatch.setattr(logmod, "_DROPPED", [0, 0])
    return logmod._RING


def _server(model, **kw):
    kw = dict(dict(canvas_hw=CANVAS, max_batch=4, batch_window_ms=30.0,
                   device="cpu"), **kw)
    return DetectServer(model, INFER, LabelCfg(), **kw)


def _images(n, seed=0):
    return list(np.random.RandomState(seed).rand(n, 56, 80, 3)
                .astype(np.float32))


def _submit_all(server, images):
    out = [None] * len(images)

    def hit(i):
        out[i] = server.submit(images[i], timeout=60)

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def served(model):
    """Ten concurrent requests, then two one at a time, through one
    server: its stats before and after, and the ring's spans."""
    ring = collections.deque(maxlen=logmod.SPAN_RING)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logmod, "_RING", ring)
        mp.setattr(logmod, "_DROPPED", [0, 0])
        server = _server(model)
        try:
            before = dict(server.stats)
            answers = _submit_all(server, _images(10))
            answers += [server.submit(img) for img in _images(2, seed=1)]
        finally:
            server.close()
        return before, dict(server.stats), list(ring), answers


def test_stats_are_flat_numbers_that_add_up(served):
    before, after, _, answers = served
    assert all(a is not None and "boxes" in a for a in answers)
    for stats in (before, after):
        assert all(type(v) in (int, float) for v in stats.values()), stats
    delta = {k: after[k] - before[k] for k in before}   # as the bench does
    assert delta["requests"] == 12
    assert delta["padded_slots"] == (delta["device_calls"] * 4
                                     - delta["requests"])
    assert (delta["closed_full"] + delta["closed_deadline"]
            == delta["device_calls"])
    seconds = [k for k in after if k.endswith("_s")]
    assert sorted(seconds) == sorted(
        ["idle_s", "window_s", "fill_s", "detect_s", "fetch_s", "scatter_s",
         "letterbox_s", "queue_wait_s"])
    assert all(after[k] >= 0 for k in seconds)
    assert after["detect_s"] > 0 and after["window_s"] > 0


def test_each_call_and_request_leaves_its_spans(served):
    _, stats, spans, _ = served
    # detect_batch's own stages, each under its call's id
    detect_calls = collections.defaultdict(dict)
    for name, t0, t1, sid, parent in spans:
        if name.startswith("detect."):
            assert sid is None and parent is not None
            detect_calls[parent][name] = (t0, t1)
    spans = [s for s in spans if not s[0].startswith("detect.")]
    calls = collections.defaultdict(dict)
    requests = collections.defaultdict(dict)
    for name, t0, t1, sid, parent in spans:
        assert t1 >= t0, name
        if parent is None:
            assert name not in calls[sid], (name, sid)
            calls[sid][name] = (t0, t1)
        else:
            assert name not in requests[sid], (name, sid)
            requests[sid][name] = (t0, t1, parent)
    assert len(calls) == stats["device_calls"]
    for stages in calls.values():
        assert tuple(stages) == CALL_STAGES       # recorded in this order
        ends = [stages[n] for n in CALL_STAGES]
        for (_, prev_end), (start, _) in zip(ends, ends[1:]):
            assert prev_end <= start             # in order, no overlap
    assert len(requests) == stats["requests"]     # one id per request
    assert not set(requests) & set(calls)
    for r in requests.values():
        assert set(r) == {"serve.letterbox", "serve.queue"}
        lb0, lb1, call = r["serve.letterbox"]
        q0, q1, same_call = r["serve.queue"]
        assert same_call == call and call in calls
        assert lb1 <= q0 <= q1 <= calls[call]["serve.window"][1]
    # one detect call a device call and the warm-up's, its stages in order
    # and, but for the warm-up's, inside the device call's serve.detect
    assert len(detect_calls) == stats["device_calls"] + 1
    served_in = 0
    for st in detect_calls.values():
        assert tuple(st) == ("detect.pyramid", "detect.boxes")
        assert st["detect.pyramid"][1] <= st["detect.boxes"][0]
        served_in += any(c["serve.detect"][0] <= st["detect.pyramid"][0]
                         and st["detect.boxes"][1] <= c["serve.detect"][1]
                         for c in calls.values())
    assert served_in == stats["device_calls"]
    # each counter is its spans' sum
    for name, key in (("serve.detect", "detect_s"),
                      ("serve.queue", "queue_wait_s")):
        total = sum(t1 - t0 for n, t0, t1, _, _ in spans if n == name)
        assert stats[key] == pytest.approx(total / 1e9, rel=1e-9, abs=1e-9)


def test_warmup_is_not_counted_and_leaves_no_span(model, ring):
    server = _server(model, warmup=True)
    try:
        assert all(v == 0 for v in server.stats.values()), server.stats
        # the server's none; the warm-up's detect call leaves its own
        assert [s[0] for s in ring] == ["detect.pyramid", "detect.boxes"]
    finally:
        server.close()
    assert len(ring) == 2 and all(v == 0 for v in server.stats.values())


def test_ring_stays_bounded_and_counts_what_it_drops(monkeypatch):
    assert logmod.SPAN_RING == 65536
    monkeypatch.setattr(logmod, "_RING", collections.deque(maxlen=8))
    for i in range(20):
        logmod.record_span("t.span", 10 * i, 10 * i + 5, i)
    assert len(logmod._RING) == 8
    assert logmod.spans_dropped() == 12
    # the 12 pushed out ended at 5 ... 115: a window from 115 lost none
    assert logmod.spans_dropped(after_ns=115) == 0
    assert logmod.spans_dropped(after_ns=114) == 12
    got = logmod.spans_between(150, 165)
    assert got == [("t.span", 150, 155, 15, None),
                   ("t.span", 160, 165, 16, None)]


def test_ring_and_ids_under_thread_contention(monkeypatch):
    """More writers than cores, switching threads as often as the
    interpreter can: no drop goes uncounted and no id repeats."""
    monkeypatch.setattr(logmod, "_RING", collections.deque(maxlen=64))
    threads_n, spans_n = 16, 2000
    ids = [[] for _ in range(threads_n)]

    def write(k):
        for i in range(spans_n):
            sid = logmod.new_span_id()
            ids[k].append(sid)
            logmod.record_span("t.stress", i, i + 1, sid)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(logmod._RING) == 64
    assert logmod.spans_dropped() == threads_n * spans_n - 64
    every = [sid for k in ids for sid in k]
    assert len(set(every)) == threads_n * spans_n


def test_ring_clock_is_the_profilers():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("clock_probe"):
            time.sleep(0.01)
            t0 = time.time_ns()
            time.sleep(0.01)
            logmod.record_span("test.clock", t0, time.time_ns())
            time.sleep(0.01)
    probe, = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "clock_probe"]
    lo, hi = probe.start_ns(), probe.start_ns() + probe.duration_ns()
    (_, s0, s1, _, _), = logmod.spans_between(0, 2 ** 63)
    assert lo - 2_000_000 <= s0 <= s1 <= hi + 2_000_000, (lo, s0, s1, hi)
    assert s0 - lo >= 5_000_000 and hi - s1 >= 5_000_000


def test_server_and_detect_batch_add_no_profiler_annotation(model):
    """Under a profile of every thread (the server works on its own), a
    server call and ``detect_batch`` add no user annotation; a range on
    another thread of the test shows that such a thread is seen."""
    from torch._C._profiler import _ExperimentalConfig

    server = _server(model, batch_window_ms=1.0)

    def control():
        with record_function("control_range"):
            torch.ones(2) + 1

    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            server.submit(_images(1)[0])
            with torch.inference_mode():
                detect_batch(model, torch.zeros((2,) + CANVAS + (3,)),
                             INFER, LabelCfg())
            t = threading.Thread(target=control)
            t.start()
            t.join()
    finally:
        server.close()
    events = list(prof.profiler.kineto_results.events())
    assert "control_range" in {e.name() for e in events}
    conv_threads = {e.start_thread_id() for e in events
                    if e.name().startswith("aten::conv")}
    assert len(conv_threads) == 2           # the server's worker and this
    annotated = {e.name() for e in events if e.is_user_annotation()}
    assert annotated == {"control_range"}, annotated
