"""Offline detection: ``densebox_tpu_torch.infer.detect_batch`` calls one
after another over batches of distinct scenes, for the window's length.

Set-up makes the weights and a pool of scenes on the device, builds the
program's model at the cell's precision (int8: calibrated on the pool's
first scenes of the seed's order) and runs one untimed call. The window
then calls ``detect_batch`` on batches drawn from the pool by the seed
(no scene twice in a call) until its time is up, and waits for the card.
``images_per_s`` counts every image of every call over all of that time.

The compared answers: a few images (drawn from the seed) of two of the
first calls; their maps are kept by a forward hook during those calls.
After the window the program is freed and the reference calibrates,
runs the int8 chain (or the float forward) on each compared image and
decodes the program's kept maps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import detection, harness, program, roofline
from port_bench.reference import compare, detect as ref_detect, model as ref
from port_bench.trace import traced


# more calls a second than any batch of the card's takes; the schedule of
# batches is made for this many
MAX_CALLS_PER_S = 20


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device
        ) -> harness.Outcome:
    from densebox_tpu_torch.infer import detect_batch

    device = torch.device(device)
    tr, spec = cell.traffic, cell.spec
    cfg = program.config(cell)
    group, rng, pool, weights, calib = detection.inputs(cell, seed, device)
    model = program.detector(cell, cfg, weights, calib, device)
    capture = program.Capture(model)

    b, n_pool = tr["batch"], tr["pool"]
    per_epoch = n_pool // b
    epochs = 1 + int(seconds * MAX_CALLS_PER_S) // per_epoch
    order = torch.as_tensor(np.stack([rng.permutation(n_pool)
                                      for _ in range(epochs)])[:, :per_epoch
                                                               * b]
                            .reshape(-1, b), device=device)
    compared_calls = sorted(rng.choice(3, spec["compare_calls"],
                                       replace=False).tolist())
    rows = {c: torch.as_tensor(np.sort(rng.choice(
        b, spec["compare_images"], replace=False)), device=device)
        for c in compared_calls}

    def call(i):
        with torch.inference_mode():
            return detect_batch(model, pool.index_select(0, order[i]),
                                cfg.infer, cfg.label)

    call(len(order) - 1)                      # warm-up: kernels, cuDNN
    _sync(device)
    setup_s = harness.process_age_s()

    kept, calls = {}, 0
    tout: dict = {}
    with traced(trace, tout):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and calls < len(order):
            capture.rows = rows.get(calls)
            out = call(calls)
            if calls in rows:
                kept[calls] = (capture.take(),
                               {k: v.index_select(0, rows[calls])
                                for k, v in out.items()})
            calls += 1
        _sync(device)
        window_s = time.perf_counter() - t0
    capture.handle.remove()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    images = calls * b
    hw = tuple(tr["canvas"])
    scales = cfg.infer.scales
    conv_dtype = "int8" if spec["precision"] == "int8" else "bf16"
    ctx = {"calls": calls, "images": images, "window_s": window_s,
           "least_s_per_call": roofline.least_s(roofline.detect_products(
               group, b, hw, scales, conv_dtype))}
    if spec["precision"] == "int8":
        ctx["qconv_bound_s_per_call"] = sum(
            roofline.qconv_bound_s(l)
            for l in roofline.detect_launches(group, b, hw, scales))

    # -- after the window: the program's state goes, the reference runs
    prog_scales = (program.scales_of(model) if spec["precision"] == "int8"
                   else None)
    compared = {c: (pool.index_select(0, order[c]), rows[c]) for c in kept}
    del model, capture, pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ctx["map_gaps"] = check(cell, group, weights, calib, kept,
                                     compared, prog_scales, hw)
    return harness.Outcome(
        attempted=images, failed=0,
        end_to_end={"images_per_s": images / window_s, "setup_s": setup_s},
        ctx=ctx, numbers=numbers, memory_peak_bytes=int(peak),
        device_kind=kind, traces=[tout["summary"]])


def check(cell, group, weights, calib, kept, images, prog_scales, hw):
    """The numbers compared: ``scale_gap`` (int8), ``map_gap``, ``det_gap``."""
    conf = cell.config["config"]
    scales = conf["infer"]["scales"]
    fwd, q = detection.reference_forward(cell, group, weights, calib)
    numbers = {}
    if q is not None:
        numbers["scale_gap"] = compare.scale_gap(prog_scales, q)
    shapes = ref.pyramid_shapes(hw[0], hw[1], scales)
    by_map, pairs = [], []
    for c, (levels, dets) in kept.items():
        batch, rows = images[c]
        for j in range(rows.shape[0]):
            mine = [{k: v[j:j + 1] for k, v in lv.items()} for lv in levels]
            want = ref.pyramid(fwd, batch, scales, rows[j:j + 1])
            by_map.append(compare.map_gaps(mine, [m for m, _ in want]))
            from_maps = ref_detect.detect(
                [(m, (sx, sy)) for m, (_, _, sx, sy) in zip(mine, shapes)],
                hw, conf["infer"], conf["label"])
            pairs.append((compare.answer(dets, j),
                          compare.answer(from_maps, 0)))
    numbers["map_gap"] = max(max(g.values()) for g in by_map)
    numbers["det_gap"] = compare.det_gap(pairs)
    return numbers, detection.widest_by_map(by_map)
