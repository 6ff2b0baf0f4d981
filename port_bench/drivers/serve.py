"""Serving: ``densebox_tpu_torch.serve.DetectServer`` under an open loop.

Set-up makes the weights and a pool of scenes on the device (copied once
to the host: a request is a host image), builds the program's model at the
cell's precision (int8: calibrated on scenes of the pool), starts the
server with the mix's ``max_batch``, window and canvas, and sends a few
untimed requests. The window is a schedule of Poisson arrivals at the mix's
fixed rate (``traffic/arrivals.py``): sender threads each take the next
request, wait for its due time and call ``submit``; every request's
latency runs from its due time to its answer, so a late sender or a
queue shows in it. Requests not answered, or answered with an error,
count as failed and lie beyond every latency.

The server's detect function is wrapped by a span that ends once the
card has finished the call (the server copies the results back right
after), and which keeps, for the first call that holds each compared
scene (drawn from the seed), that slot's maps and outputs. After the
window every answer to a compared scene is held to the reference's
detections from those maps, and the maps to the reference's own forward
of the scene.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from port_bench import detection, harness, program, roofline
from port_bench.reference import compare, detect as ref_detect, model as ref
from port_bench.trace import traced
from port_bench.traffic.arrivals import poisson_due, scene_order
from port_bench.traffic.scenes import fingerprint


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile of finite or infinite values."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, int(np.ceil(q / 100.0 * len(v))) - 1)])


def _finite(v: float):
    return v if np.isfinite(v) else None


class Probe:
    """The wrapper of the server's detect function: spans, and the maps
    and outputs of the first call holding each compared scene."""

    def __init__(self, server, model, compared, device):
        self.server, self.device = server, device
        self.inner = server._detect
        self.capture = program.Capture(model)
        self.wanted = set(int(s) for s in compared)
        self.kept = {}
        self.spans = []
        self.recording = False

    def __call__(self, images):
        host = self.server._host.numpy()
        slots = {}
        for i in range(host.shape[0]):
            s = fingerprint(host[i])
            if s in self.wanted and s not in self.kept and s not in slots:
                slots[s] = i
        if slots:
            self.capture.rows = torch.as_tensor(sorted(slots.values()),
                                                device=self.device)
        t0 = time.perf_counter()
        out = self.inner(images)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t1 = time.perf_counter()
        if self.recording:
            self.spans.append((t0, t1))
        if slots:
            levels = self.capture.take()
            for j, (s, i) in enumerate(sorted(slots.items(),
                                              key=lambda kv: kv[1])):
                self.kept[s] = ([{k: v[j:j + 1] for k, v in lv.items()}
                                 for lv in levels], images.clone(), i)
        return out


def run(cell, seed: int, seconds: float, trace: bool, device
        ) -> harness.Outcome:
    from densebox_tpu_torch.serve import DetectServer

    device = torch.device(device)
    tr, spec = cell.traffic, cell.spec
    cfg = program.config(cell)
    group, rng, pool, weights, calib = detection.inputs(cell, seed, device)
    host_scenes = pool.cpu().numpy()
    model = program.detector(cell, cfg, weights, calib, device)
    server = DetectServer(model, cfg.infer, cfg.label,
                          canvas_hw=tuple(tr["canvas"]),
                          max_batch=tr["max_batch"],
                          batch_window_ms=tr["batch_window_ms"],
                          device=device)
    compared = rng.choice(tr["pool"], spec["compare_scenes"], replace=False)
    probe = Probe(server, model, compared, device)
    server._detect = probe

    due = poisson_due(tr["rate_per_s"], seconds, rng)
    which = scene_order(len(due), tr["pool"], rng)
    n = len(due)
    sent = np.full(n, np.nan)
    done = np.full(n, np.inf)
    answers = {}
    nxt = [0]
    lock = threading.Lock()

    def sender(t0, items, timeout, record):
        while True:
            with lock:
                i = nxt[0]
                if i >= len(items):
                    return
                nxt[0] += 1
            due_i, scene = items[i]
            wait = t0 + due_i - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sent_at = time.perf_counter()
            try:
                ans = server.submit(host_scenes[scene], timeout=timeout)
            except (RuntimeError, TimeoutError):
                ans = None
            end = time.perf_counter()
            if record:
                sent[i] = sent_at - t0 - due_i
                if ans is not None:
                    done[i] = end - t0 - due_i
                    if int(scene) in probe.wanted:
                        answers.setdefault(int(scene), []).append(ans)

    def send_all(items, t0, timeout, record):
        nxt[0] = 0
        threads = [threading.Thread(target=sender,
                                    args=(t0, items, timeout, record))
                   for _ in range(min(tr["senders"], len(items)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout + seconds + 60.0)
        if any(t.is_alive() for t in threads):
            raise RuntimeError("a sender thread did not end")

    warm = [(0.0, int(s)) for s in rng.choice(
        np.setdiff1d(np.arange(tr["pool"]), compared),
        tr["warmup_requests"])]
    window_items = [(float(d), int(s)) for d, s in zip(due, which)]
    send_all(warm, time.perf_counter(), 60.0, False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = harness.process_age_s()

    tout: dict = {}
    with traced(trace, tout):
        before = dict(server.stats)
        probe.recording = True
        t0 = time.perf_counter() + 0.02
        send_all(window_items, t0, seconds + 60.0, True)
        probe.recording = False
        stats = {k: server.stats[k] - before[k] for k in before}
        window_s = time.perf_counter() - t0
    server.close()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    lat_ms = done * 1e3
    failed = int(np.sum(~np.isfinite(done)))
    hw = tuple(tr["canvas"])
    conv_dtype = "int8" if spec["precision"] == "int8" else "bf16"
    ctx = {"window_s": window_s, "stats": stats, "lags_s": sent,
           "latency_s": done, "due_s": due,
           "spans": list(probe.spans),
           "least_s_per_image": roofline.least_s(roofline.detect_products(
               group, 1, hw, cfg.infer.scales, conv_dtype))}
    prog_scales = (program.scales_of(model) if spec["precision"] == "int8"
                   else None)
    kept = probe.kept
    del server, model, probe, pool, host_scenes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ctx["map_gaps"] = check(cell, group, weights, calib, kept,
                                     answers, prog_scales, hw)
    return harness.Outcome(
        attempted=n, failed=failed,
        end_to_end={"latency_p95_ms": _finite(_percentile(lat_ms, 95.0)),
                    "setup_s": setup_s},
        ctx=ctx, numbers=numbers, memory_peak_bytes=int(peak),
        device_kind=kind, traces=[tout["summary"]])


def check(cell, group, weights, calib, kept, answers, prog_scales, hw):
    """The numbers compared: ``scale_gap`` (int8), ``map_gap`` of each
    compared scene's slot against the reference's forward of the same
    device batch, ``det_gap`` of every answer to it."""
    conf = cell.config["config"]
    scales = conf["infer"]["scales"]
    fwd, q = detection.reference_forward(cell, group, weights, calib)
    numbers = {}
    if q is not None:
        numbers["scale_gap"] = compare.scale_gap(prog_scales, q)
    shapes = ref.pyramid_shapes(hw[0], hw[1], scales)
    by_map, pairs = [], []
    for s, (levels, batch, slot) in sorted(kept.items()):
        rows = torch.tensor([slot], device=batch.device)
        want = ref.pyramid(fwd, batch, scales, rows)
        by_map.append(compare.map_gaps(levels, [m for m, _ in want]))
        from_maps = compare.answer(ref_detect.detect(
            [(m, (sx, sy)) for m, (_, _, sx, sy) in zip(levels, shapes)],
            hw, conf["infer"], conf["label"]), 0)
        pairs += [(a, from_maps) for a in answers.get(s, [])]
    numbers["map_gap"] = (max(max(g.values()) for g in by_map)
                          if by_map else float("inf"))
    numbers["det_gap"] = compare.det_gap(pairs) if pairs else float("inf")
    return numbers, detection.widest_by_map(by_map)
