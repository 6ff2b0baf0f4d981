#!/usr/bin/env python3
"""The port's kernels, and the alternatives no benchmark cell runs, timed
on the card.

    python3 profile_port.py [--calls 5] [--only qconv,small_kernels,nms]   # repository root, one CUDA card

Who does what: ``port_bench`` (``BENCHMARK.json``) measures the serving,
offline and train cells end to end and splits their time by layer; the
gpu-marked tests (``tests/test_torch_kernels.py``, ``test_torch_neck.py``)
hold each kernel to its plain version; ``chip_smoke.py`` drives the
program's entry points on the card and checks each kernel once at the main
path's shapes; this script times each kernel alone. The kernels' cases and
bounds that its probes, the tests and ``chip_smoke.py`` share are in
``kernel_cases.py``. Device time is CUDA-graph replay (``device_ms``); a
floor is an empty launch of the kernel's grid (``empty_launch_ms``,
``csrc/floor.cu``); event and plain ms are one eager call of the kernel
and of its plain version, by CUDA events (``event_and_plain``), at the
shape of each kernel's row in PERF.md's table of kernels.

Prints one JSON line per probe, after the card's name and power limit:
  fused_conv  the paper model's conv1_2 at B=8, 480x640, bf16: nn.Conv2d
              and ReLU as the model runs them, against cuDNN's fused
              conv+bias+ReLU (torch.cudnn_convolution_relu), by CUDA events,
              alternated, with the largest difference of their outputs;
  resize      infer/resize.py's einsum form against batched products on
              NHWC as it lies, at each level of the paper model's pyramid;
  qconv       three lines. ``qconv``: the int8 conv kernel's device time at
              every conv shape of the turbo int8 model (B=8, in the mode the
              model runs the layer in) beside its bound, the same values
              through cuDNN's bf16 ``F.conv2d`` and, for the 1x1 layers
              cuBLASLt takes, ``torch._int_mm`` (the int32 accumulator only,
              no epilogue), and their sums over the 14 launches of a device
              call; four of those layers at B = 1 to 32 (the cost of a
              launch and of a round of tiles); kitti's offline launches at
              B=64 (5 replayed) beside their least time; and the paper-width
              int8 forward (B=2, 240x320) on the host clock with its kernel
              time by kind. ``requant``: ``requant_epilogue`` at the
              accumulator of each of those 14 launches (a hybrid device
              call) beside its bound, and the sums. ``int8_neck``: the neck
              at kitti's four scales of a 480x640 canvas, a call's four
              launches at B=8 and 64, beside the bound of their bytes. Uses
              only the kernel wrappers and ``QuantDenseBox``, so the same
              script times an older tree of the package;
  determinism which kernels of a train step differ run to run, and what
              pinning them costs: for each train cell (f32) the same step
              (same state, batch and generator state) taken three times in
              each mode: ``unpinned`` (the step's own pinning taken out),
              ``shipped`` (the step as ``make_train_step`` gives it),
              ``cudnn_deterministic`` (that flag alone, set from outside) and
              ``deterministic_algorithms``
              (``torch.use_deterministic_algorithms(True, warn_only=True)``:
              its warnings name every operation PyTorch knows to be
              nondeterministic): the parameters whose gradients differ
              between runs with the largest difference, whether parameters,
              momentum and ``update_norm`` repeat bit for bit, and ms/step
              of each mode over 10 steps, in turns;
  export      for turbo_int8 and paper (B=8, 480x640): a device call
              (pinned host batch -> detect -> results on the host, on the
              host clock) through the live path, through the live path with
              the custom-op dispatch taken out (each wrapper calling its
              CUDA launch directly) and through the artifact
              (``export.py``, exported and loaded here), 20 calls each in
              turns (live, direct, artifact, artifact, direct, live) x 2,
              median (q1, q3); then a trace of --calls artifact calls;
  small_kernels  ``ohem_select`` (B=32, P=3600, errors of the paper model's
              forward) beside its bound and two floors: an empty launch of
              its grid, and that launch plus the chain of block-wide rounds
              the worst sample needs by the schedule's numpy model;
              ``gather_windows`` (the MALF serve shape in bf16 and f32, the
              bench's lm4 shape in bf16) beside its bound, an empty launch
              of its grid and ``torch.take`` at a prebuilt index; the two GT
              rasterizers (B=32, K=16, M=60, L=5) beside their bounds and
              empty launches of their grids, on a train step's rows too,
              both maps in one launch, and the landmark kernel against its
              blocks a patch. Two readings of each device time. Uses only
              the wrappers, so the same script times an older tree of the
              package;
  slot        for paper bf16, malf_bf16, paper f32 (kitti_vehicle()),
              turbo_int8 and turbo_int8_lm4 at B=8, 480x640 (served
              requests letterboxed): which operations make an image's
              result depend on its slot in the batch, each alone on its
              recorded input under every roll of the batch, with cuDNN's
              convolutions in several bodies (``conv_variants``); the whole
              forward and the served check for each body, and its device
              call's time (``probe_slot``);
  nms         the greedy-NMS kernel alone at B=8 with K=256, 512 and 1024,
              B=256 with K=256 and B=64 with K=512, on a random, an
              all-kept and a chained set, each mask checked against the
              plain version, beside its bound and an empty launch of its
              grid; and the host's time of a call (wrapper, dispatch,
              launch; 100 enqueued without a synchronisation). Uses only
              ``greedy_keep``, so the same script times an older tree of
              the package.
At the shape of each kernel's row in PERF.md's table of kernels (NMS at
B=8, K=512 on the random set; the turbo conv3_2 and its requant; the MALF
window in bf16; both rasterizers; OHEM; the neck at B=8 and 64) a probe
adds ``event_ms`` and ``plain_ms`` (``event_and_plain``).
``--only`` takes a comma-separated subset of the groups fused_conv, resize,
qconv, determinism, export, small_kernels, slot, nms; the default is all.
Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import os
import sys
import time
import warnings
from unittest import mock

import numpy as np

from chip_smoke import (card_line, emit, event_seconds, init_model,
                        init_quant_model, landmark_cells, request_images,
                        serving_cells, train_cfgs, with_live_threshold)
from kernel_cases import (KITTI_OFFLINE, NMS_SHAPES, QCONV_CASES, TRAIN_RASTER,
                          TURBO_LAUNCHES, WINDOW_CASES, label_rows,
                          neck_bound, neck_levels, nms_bound, nms_set,
                          ohem_bound, ohem_forward_case, qconv_bound,
                          qconv_inputs, rasterizer_bounds, requant_bound,
                          window_bound, window_inputs)
from port_bench.trace import kernel_kind

CANVAS = (8, 480, 640, 3)


# --- timing ------------------------------------------------------------------

def median_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    return float(np.median(event_seconds(fn, reps))) * 1e3


def event_and_plain(kernel, plain, plain_reps: int = 10) -> dict:
    """An eager call of the kernel and of its plain version on the same
    inputs, by CUDA events (``median_ms``): the wrapper's host time shows in
    the first, and the second is what the kernel replaced."""
    return {"event_ms": median_ms(kernel, 50),
            "plain_ms": median_ms(plain, plain_reps)}


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured into a
    CUDA graph, the graph replayed between one pair of events, the median of
    ``reps`` replays over ``launches``. A replay costs the host one launch,
    so the events bracket the kernels and not their enqueue (an event pair
    around one eager call of a 10 us kernel reads mostly the wrapper).
    Inputs and outputs stay in the L2 cache from launch to launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def _floor_launch(entry: str, argtypes, *args) -> float:
    """``device_ms`` of one of ``csrc/floor.cu``'s launches: ``entry``
    called with ``args`` and the current stream."""
    import torch

    from densebox_tpu_torch.ops.kernels import build

    fn = getattr(build.load("floor"), entry)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} failed with CUDA error {rc}")

    return device_ms(launch)


def empty_launch_ms(grid_x: int, grid_y: int, block: int) -> float:
    """An empty kernel of that grid and block: what the launch alone costs
    before any work."""
    return _floor_launch("densebox_empty_launch", [ctypes.c_int] * 3,
                         grid_x, grid_y, block)


def round_chain_ms(batch: int, threads: int, rounds: int) -> float:
    """``rounds`` dependent block-wide rounds through
    ``csrc/block_reduce.cuh`` in ``batch`` blocks of ``threads`` and nothing
    else: what the counts of ``csrc/ohem.cu``'s bisections cost."""
    import torch

    scratch = torch.empty(batch, dtype=torch.int32, device="cuda")
    return _floor_launch("densebox_round_chain",
                         [ctypes.c_void_p] + [ctypes.c_int] * 3,
                         scratch.data_ptr(), batch, threads, rounds)


DEVICE_TIMING = ("device time: 20 launches replayed as a CUDA graph between "
                 "one pair of events, median of 5")


def ohem_chain(args):
    """The longest chain of dependent steps a sample of ``args`` puts on its
    block under the kernel's schedule (its numpy model): block-wide rounds
    (4 outside the bisections, then per bisection the counted rounds and the
    2 barriers around the warp's part) and levels one warp walks alone."""
    from densebox_tpu_torch.ops.kernels import ohem as ko

    _, calls = ko.reference_bisections(*args, 1.0, 0.5, 16)
    calls = [[t.cpu().numpy() for t in call] for call in calls]
    worst = (0, 0)
    for i in range(len(calls[0][0])):
        rounds, warp = 4, 0
        for values, cand, n_want, _ in calls:
            _, r, w = ko.staged_threshold(values[i], cand[i], int(n_want[i]))
            rounds += r + (2 if w else 0)
            warp += w
        worst = max(worst, (rounds, warp))
    return {"block_rounds": worst[0], "warp_levels": worst[1]}


# --- yardsticks: one library call for the same function -----------------------

def conv_library_ms(args) -> float:
    """One PyTorch call for the int8 conv's function, as its yardstick: the
    same int8 values as bf16 through ``F.conv2d`` (cuDNN; int8 codes are
    exact in bf16, sums in f32), without the requant epilogue; device time,
    read as the kernel's is."""
    import torch
    import torch.nn.functional as F

    x, wq = args[:2]
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)     # channels_last NCHW
    wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16)
    pad = wq.shape[1] // 2
    return device_ms(lambda: F.conv2d(xb, wb, padding=pad))


def int_mm_library(args) -> dict:
    """One PyTorch call for a 1x1 int8 layer's int32 accumulator, as the
    kernel's yardstick: ``torch._int_mm`` (cuBLASLt) of the activations
    (B*H*W, Cin) and the weights (Cin, Cout), without the epilogue; its
    device time, read as the kernel's is, and whether it equals the exact
    product."""
    import torch

    x, wq = args[:2]
    a = x.reshape(-1, x.shape[-1])
    w = wq.reshape(wq.shape[0], -1).t()       # (Cin, Cout), column-major
    exact = (a.double() @ w.double()).to(torch.int32)   # |sum| < 2**53
    return {"library_int_mm_ms": device_ms(lambda: torch._int_mm(a, w)),
            "int_mm_equal": bool(torch.equal(torch._int_mm(a, w), exact)),
            "library_int_mm": "accumulator only, no epilogue"}


def window_library(maps, sel, y0, x0, win) -> dict:
    """One PyTorch call for ``gather_windows``, as its yardstick: one
    ``torch.take`` of the flat maps at an index of every window element,
    built beforehand; its device time, read as the kernel's is, and whether
    it equals the kernel's windows."""
    import torch

    from densebox_tpu_torch.ops.kernels.window import gather_windows

    _, n_s, n_l, hm, wm = maps.shape
    ar = torch.arange(win, device="cuda")
    rows = (y0.long().clamp(0, hm - win)[..., None] + ar)[..., :, None]
    cols = (x0.long().clamp(0, wm - win)[..., None] + ar)[..., None, :]
    plane = ((torch.arange(maps.shape[0], device="cuda")[:, None, None]
              * n_s + sel.long()[:, :, None]) * n_l
             + torch.arange(n_l, device="cuda"))[..., None, None]
    flat = (plane * hm + rows) * wm + cols
    return {"library_take_ms": device_ms(lambda: torch.take(maps, flat)),
            "take_equal": bool(torch.equal(
                torch.take(maps, flat),
                gather_windows(maps, sel, y0, x0, win))),
            "library_call": "torch.take(maps, index) with a prebuilt index"}


def host_times(fn, reps: int):
    """Host-clock ms of ``reps`` calls that end synchronised, after a
    warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def quartiles(times):
    return [float(np.median(times)), float(np.percentile(times, 25)),
            float(np.percentile(times, 75))]


def host_ms(fn, reps: int):
    """Median, q1 and q3 host-clock ms of a call that ends synchronised."""
    return quartiles(host_times(fn, reps))


def trace_calls(call, calls):
    """A torch.profiler trace of ``calls`` calls: wall and kernel time per
    call, kernel time by kind and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, top = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / calls
        by_kind[kernel_kind(ev.key)] = by_kind.get(kernel_kind(ev.key), 0) + ms
        top.append((ms, ev.count // calls, ev.key[:100]))
    kernel = sum(by_kind.values())
    return {"traced_calls": calls, "wall_ms_per_call": wall / calls,
            "kernel_ms_per_call": kernel,
            "kernel_ms_per_call_by_kind": by_kind,
            "top_kernels_ms_launches_per_call": sorted(top)[::-1][:12]}


def probe_export(name, model_cfg, infer_cfg, label_cfg, host, calls, quant):
    """A serving cell's device call through the live path, the live path
    without the custom-op dispatch, and its exported artifact."""
    import tempfile

    from densebox_tpu_torch.export import (artifact_meta,
                                           export_detect_program,
                                           load_exported, save_exported)
    from densebox_tpu_torch.infer import make_detect_fn
    from densebox_tpu_torch.ops.kernels import nms, qconv

    x = host.cuda()
    model = (init_quant_model(model_cfg, x, quant) if quant
             else init_model(model_cfg, "cuda"))
    infer_cfg = with_live_threshold(model, x, infer_cfg)
    live = make_detect_fn(model, infer_cfg, label_cfg)
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "a.pt2")
        save_exported(path, export_detect_program(
            model, infer_cfg, label_cfg, CANVAS[0], CANVAS[1:3]),
            artifact_meta(model, infer_cfg, CANVAS[0], CANVAS[1:3]))
        artifact, _ = load_exported(path)

    def through(detect):
        def call():
            out = detect(host.to("cuda", non_blocking=True))
            return {k: v.cpu() for k, v in out.items()}
        return call

    def no_dispatch():
        """Each wrapper calls its CUDA launch directly."""
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(nms, "_greedy_keep_op",
                                              nms._greedy_keep_cuda))
        stack.enter_context(mock.patch.object(qconv, "_qconv_op",
                                              qconv._qconv_cuda))
        return stack

    times = {"live": [], "direct": [], "artifact": []}
    for which in ("live", "direct", "artifact", "artifact", "direct",
                  "live") * 2:
        with (no_dispatch() if which == "direct"
              else contextlib.nullcontext()):
            times[which] += host_times(through(
                artifact if which == "artifact" else live), 5)
    return {"probe": "export", "cell": name,
            "device_call_ms": {k: quartiles(v) for k, v in times.items()},
            "timing": "host clock around a synchronised call (pinned batch "
                      "in, results on the host), 20 calls each in turns",
            "artifact_trace": trace_calls(through(artifact), calls)}


def probe_fused_conv(model_cfg):
    import torch

    conv = init_model(model_cfg, "cuda").conv1_2
    x = torch.rand(CANVAS[0], conv.in_channels, *CANVAS[1:3], device="cuda",
                   dtype=conv.weight.dtype).to(memory_format=torch.channels_last)
    with torch.inference_mode():
        def unfused():
            return torch.relu(conv(x))

        def fused():
            return torch.cudnn_convolution_relu(
                x, conv.weight, conv.bias, (1, 1), (1, 1), (1, 1), 1)

        diff = float((unfused() - fused()).abs().max())
        times = {"unfused": [], "fused": []}
        for _ in range(2):
            times["unfused"].append(median_ms(unfused, 20))
            times["fused"].append(median_ms(fused, 20))
    return {"probe": "fused_conv", "layer": "conv1_2",
            "input": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "max_abs_diff": diff, "median_ms_alternated": times}


def resize_products(images, hw):
    """The alternative to ``resize_linear``: the same weights applied as
    batched products on NHWC as it lies (the second has C = 3 columns)."""
    from densebox_tpu_torch.infer.resize import _weights

    b, h, w, c = images.shape
    hs, ws = hw
    y = images.contiguous()
    if hs != h:
        wt = _weights(h, hs, y.device, y.dtype)
        y = (wt @ y.reshape(b, h, w * c)).reshape(b, hs, w, c)
    if ws != w:
        wt = _weights(w, ws, y.device, y.dtype)
        y = (wt @ y.reshape(b * hs, w, c)).reshape(b, hs, ws, c)
    return y


def probe_resize(infer_cfg, host):
    import torch

    from densebox_tpu_torch.infer import pyramid_shapes, resize_linear

    x = host.cuda()
    out = {"probe": "resize", "input": list(x.shape)}
    with torch.inference_mode():
        for hs, ws, _, _ in pyramid_shapes(*CANVAS[1:3], infer_cfg.scales):
            if (hs, ws) == CANVAS[1:3]:
                continue
            diff = float((resize_linear(x, (hs, ws))
                          - resize_products(x, (hs, ws))).abs().max())
            out[f"{hs}x{ws}"] = {
                "einsum_ms": [median_ms(lambda: resize_linear(x, (hs, ws)), 20)
                              for _ in range(2)],
                "products_ms": [median_ms(lambda: resize_products(x, (hs, ws)),
                                          20) for _ in range(2)],
                "max_abs_diff": diff}
    return out


def probe_qconv():
    """The int8 conv kernel's device time at every conv shape of the turbo
    int8 model (B=8, in the mode the model runs the layer in) beside its
    bound and the library calls, at kitti's offline shapes (B=64), and the
    paper-width int8 forward."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.ops.kernels import qconv as kq

    rng = np.random.RandomState(5)
    layers, kitti = {}, {}
    for name, *shape in QCONV_CASES:
        b, h, w, cin, cout, k = shape
        x, wq, scale, bias, osc = qconv_inputs(rng, *shape, "cuda")
        variant = kq.kernel_variant(cin, cout, k)
        if name in KITTI_OFFLINE:
            # the offline chain's mode (int8 codes out), port_bench's bytes
            bnd = qconv_bound(*shape)
            ms = [device_ms(lambda: kq.qconv_int8(x, wq, scale, bias, osc),
                            launches=5) for _ in range(2)]
            kitti[name] = {"variant": variant, "plan": dict(kq.last_plan),
                           "device_ms": ms, "launches_replayed": 5, "bound_ms": bnd[0],
                           "bound_by": bnd[1],
                           "roofline_share_pct": 100.0 * bnd[0] / min(ms)}
            continue
        # the mode the model runs the layer in (f32 from the heads' conv2)
        f32_out = cout <= 4
        kw = dict(relu=False) if f32_out else dict(out_scale=osc)
        args = (x, wq, scale, bias)
        bnd = qconv_bound(*shape, f32_out)
        layers[name] = {
            "variant": variant, "mode": "f32" if f32_out else "int8",
            "device_ms": [device_ms(lambda: kq.qconv_int8(*args, **kw))
                          for _ in range(2)],
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_bf16_conv_ms": conv_library_ms(args),
            "launches_per_call": TURBO_LAUNCHES[name]}
        if k == 1 and cin % 8 == 0 and cout % 8 == 0:
            layers[name].update(int_mm_library(args))
        if name == "turbo_conv3_2":
            layers[name].update(event_and_plain(
                lambda: kq.qconv_int8(*args, **kw),
                lambda: kq.qconv_reference(*args, **kw)))

    def per_call(key, names=layers):
        return sum(min(np.atleast_1d(layers[n][key]))
                   * layers[n]["launches_per_call"] for n in names)

    mm = [n for n, v in layers.items() if "library_int_mm_ms" in v]
    # device time against the batch: what a launch costs before its first
    # tile is done, and what each further round of tiles adds
    scaling = {}
    for name, *shape in QCONV_CASES:
        if name not in SCALED_LAYERS:
            continue
        for b in (1, 2, 4, 8, 16, 32):
            x, wq, scale, bias, osc = qconv_inputs(rng, b, *shape[1:], "cuda")
            scaling.setdefault(name, {})[f"B{b}"] = device_ms(
                lambda: kq.qconv_int8(x, wq, scale, bias, out_scale=osc))
    cfg = dataclasses.replace(kitti_vehicle().model, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 240, 320, 3)
                         .astype(np.float32)).cuda()
    model = init_quant_model(cfg, x)

    def call():
        with torch.inference_mode():
            return model(x)

    res = {"probe": "qconv", "batch": 8, "timing": DEVICE_TIMING,
           "layers": layers,
           "per_device_call_14_launches": {
               "device_ms": per_call("device_ms"),
               "bound_ms": per_call("bound_ms"),
               "library_bf16_conv_ms": per_call("library_bf16_conv_ms"),
               "int_mm_layers": {
                   "device_ms": per_call("device_ms", mm),
                   "library_int_mm_ms": per_call("library_int_mm_ms", mm)}},
           "device_ms_by_batch": scaling,
           "kitti_offline_b64": kitti,
           "paper_int8_forward": {"input": list(x.shape),
                                  "forward_ms": host_ms(call, 10)}}
    res["paper_int8_forward"].update(trace_calls(call, 3))
    return res


def probe_requant():
    """``requant_epilogue`` at the accumulator of every conv of a hybrid
    device call of the turbo int8 model (B=8), in the mode the model runs
    the layer in, beside its bound (int32 in, int8 or f32 out, three float
    vectors; five float operations an element), and the sums over the
    call's 14 launches."""
    import torch

    from densebox_tpu_torch.ops.kernels import requant as kr

    rng = np.random.RandomState(6)
    layers = {}
    for name, b, h, w, _, cout, _ in QCONV_CASES:
        if name not in TURBO_LAUNCHES:
            continue
        acc = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, (b, h, w, cout))
                               .astype(np.int32)).cuda()
        vecs = [torch.from_numpy(rng.uniform(lo, hi, cout).astype(np.float32))
                .cuda() for lo, hi in ((1e-6, 3e-6), (-0.5, 0.5), (20, 40))]
        f32_out = cout <= 4                      # the heads' conv2
        args = (acc, vecs[0], vecs[1], None if f32_out else vecs[2])
        kw = dict(relu=not f32_out)
        bnd = requant_bound(acc.numel(), cout, f32_out)
        layers[name] = {
            "shape": list(acc.shape), "mode": "f32" if f32_out else "int8",
            "device_ms": [device_ms(lambda: kr.requant_epilogue(*args, **kw))
                          for _ in range(2)],
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "launches_per_call": TURBO_LAUNCHES[name]}
        if name == "turbo_conv3_2":          # 8 x 120 x 160 x 64, int8 out
            layers[name].update(event_and_plain(
                lambda: kr.requant_epilogue(*args, **kw),
                lambda: kr.requant_reference(*args, **kw), 20))
    per_call = {key: sum(min(np.atleast_1d(v[key])) * v["launches_per_call"]
                         for v in layers.values())
                for key in ("device_ms", "bound_ms")}
    per_call["share_of_bound"] = per_call["bound_ms"] / per_call["device_ms"]
    return {"probe": "requant", "batch": 8, "timing": DEVICE_TIMING,
            "layers": layers, "per_hybrid_call_14_launches": per_call}


def probe_neck():
    """The int8 neck at kitti's four scales of a 480 x 640 canvas (256 + 512
    channels), a call's four launches at B=8 (the serve batch) and 64 (the
    offline one), beside the bound of their bytes, and one eager call of
    the kernel and of its plain version."""
    import torch

    from densebox_tpu_torch.ops.kernels import neck as kneck

    s3 = torch.tensor(0.0173, device="cuda")
    so = torch.tensor(0.0219, device="cuda")
    calls = {}
    for b in (8, 64):
        levels = neck_levels(b, seed=b)

        def call():
            return [kneck.int8_neck(f3, f4, s3, so) for f3, f4 in levels]

        def plain():
            return [kneck.neck_reference(f3, f4, s3, so) for f3, f4 in levels]

        *bnd, nbytes = neck_bound(levels)
        dev = [device_ms(call, 20 if b == 8 else 3) for _ in range(2)]
        calls[f"B{b}"] = {"device_ms": dev,
                          "device_ms_per_image": min(dev) / b,
                          "bytes": nbytes, "bound_ms": bnd[0],
                          "bound_by": bnd[1],
                          "share_of_bound": bnd[0] / min(dev),
                          **event_and_plain(call, plain, 5)}
        del levels
        torch.cuda.empty_cache()
    return {"probe": "int8_neck", "canvas": [480, 640], "channels": [256, 512],
            "timing": "device time of a call's four launches: 20 calls (B=8) "
                      "or 3 (B=64) replayed as a CUDA graph between one pair "
                      "of events, median of 5; two readings; event_ms, "
                      "plain_ms: CUDA events around one eager call, median",
            "calls": calls}


def probe_determinism(name, cfg, canvas):
    """Which gradients of a train step differ run to run, under which
    pinning they stop, and what each pinning costs."""
    import torch

    from densebox_tpu_torch import DenseBox
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.train import (create_train_state, loop,
                                          make_canvas_train_step,
                                          make_train_step)

    data_label = (dataclasses.replace(cfg.label, patch_size=480) if canvas
                  else cfg.label)
    model = DenseBox(cfg.model)
    state = create_train_state(model, cfg)
    step = (make_canvas_train_step if canvas else make_train_step)(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = synthetic_batch(gen, cfg.train.batch_size, data_label,
                            cfg.train.max_boxes, cfg.model.num_landmarks)
    start = {"params": {k: v.clone() for k, v in model.state_dict().items()},
             "momentum": {k: v.clone() for k, v in state.momentum.items()},
             "generator": state.generator.get_state()}

    def rewind():
        state.load(start["params"], start["momentum"], 0)
        state.generator.set_state(start["generator"])

    unpinned = mock.patch.object(loop, "repeatable_kernels",
                                 contextlib.nullcontext)

    @contextlib.contextmanager
    def cudnn_flag():
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = before

    @contextlib.contextmanager
    def all_algorithms():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)

    def mode(name_):
        stack = contextlib.ExitStack()
        if name_ != "shipped":
            stack.enter_context(unpinned)
        if name_ == "cudnn_deterministic":
            stack.enter_context(cudnn_flag())
        if name_ == "deterministic_algorithms":
            stack.enter_context(all_algorithms())
        return stack

    modes = ("unpinned", "shipped", "cudnn_deterministic",
             "deterministic_algorithms")
    res = {"probe": "determinism", "cell": name,
           "batch": cfg.train.batch_size, "modes": {}}
    for m in modes:
        runs, warned = [], set()
        with mode(m), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                rewind()
                _, metrics = step(state, batch)
                torch.cuda.synchronize()
                runs.append({
                    "grads": {k: p.grad.clone()
                              for k, p in model.named_parameters()},
                    "params": {k: p.detach().clone()
                               for k, p in model.named_parameters()},
                    "momentum": {k: v.clone()
                                 for k, v in state.momentum.items()},
                    "update_norm": metrics["update_norm"].clone(),
                    "loss": metrics["loss_total"].clone()})
            warned = sorted({str(w.message).split(".")[0][:160]
                             for w in caught})
        differing = {}
        for k in runs[0]["grads"]:
            d = max(float((r["grads"][k] - runs[0]["grads"][k]).abs().max())
                    for r in runs[1:])
            if d > 0:
                differing[k] = d / float(runs[0]["grads"][k].abs().max())
        same = {key: all(torch.equal(r[key][k], runs[0][key][k])
                         for r in runs[1:] for k in runs[0][key])
                for key in ("params", "momentum")}
        same["update_norm"] = all(torch.equal(r["update_norm"],
                                              runs[0]["update_norm"])
                                  for r in runs[1:])
        same["loss"] = all(torch.equal(r["loss"], runs[0]["loss"])
                           for r in runs[1:])
        res["modes"][m] = {
            "grads_differing_rel_to_max": differing, "bit_equal": same,
            "update_norms": [float(r["update_norm"]) for r in runs],
            "warnings": warned}
    times = {m: [] for m in modes}
    for _ in range(2):
        for m in modes:
            with mode(m), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                rewind()
                step(state, batch)          # cuDNN settles on its algorithms
                times[m].append(host_ms(lambda: step(state, batch), 10)[0])
    res["step_ms_two_readings"] = times
    return res


def probe_nms():
    """The greedy-NMS kernel alone at the main path's shapes
    (``NMS_SHAPES``) on three of the tests' sets: random, all kept
    (disjoint) and one chain of suppressions K long; each mask held to the
    plain version, beside the bound and an empty launch of the kernel's
    grid. Uses only ``greedy_keep``, so the same script times an older tree
    of the package."""
    import torch

    from densebox_tpu_torch.ops.kernels import nms as knms

    res = {"probe": "nms", "timing": DEVICE_TIMING + "; two readings"}
    for b, k in NMS_SHAPES:
        for name in ("random", "disjoint", "chain"):
            boxes, valid = nms_set(name, b, k, seed=1)
            tb = torch.from_numpy(boxes).cuda()
            tv = torch.from_numpy(valid).cuda()
            res[f"{name}_B{b}_K{k}"] = {
                "equal": bool(torch.equal(
                    knms.greedy_keep(tb, tv, 0.5),
                    knms.greedy_keep_reference(tb, tv, 0.5))),
                "device_ms": [device_ms(lambda: knms.greedy_keep(tb, tv, 0.5))
                              for _ in range(2)],
                "bound_ms": nms_bound(valid)[0]}
            if (name, b, k) == ("random", 8, 512):
                res[f"{name}_B{b}_K{k}"].update(event_and_plain(
                    lambda: knms.greedy_keep(tb, tv, 0.5),
                    lambda: knms.greedy_keep_reference(tb, tv, 0.5), 7))
        cluster, threads = knms.launch_shape(b, k)
        res[f"floor_B{b}_K{k}"] = empty_launch_ms(cluster, b, threads)
        # the host's side of a call: wrapper, custom-op dispatch and launch,
        # enqueued 100 at a time without a synchronisation between them
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                knms.greedy_keep(tb, tv, 0.5)
            host.append((time.perf_counter() - t0) / 100 * 1e6)
        torch.cuda.synchronize()
        res[f"host_us_B{b}_K{k}"] = float(np.median(host))
    return res


def probe_small_kernels():
    """The OHEM, window-gather and rasterizer kernels at the main path's
    shapes, through their wrappers alone, beside their bounds and floors."""
    import torch

    from densebox_tpu_torch.ops.kernels import build
    from densebox_tpu_torch.ops.kernels.ohem import (ohem_select,
                                                     ohem_select_reference)
    from densebox_tpu_torch.ops.kernels.window import (
        gather_windows, gather_windows_reference)

    args = ohem_forward_case(32)
    b, p = args[0].shape
    # floors: an empty launch of the kernel's grid and block, and that
    # launch plus the chain of block-wide rounds through the kernel's
    # reducer that the worst sample needs (the levels one warp walks alone
    # are counted beside it and not timed)
    threads = build.load("ohem").densebox_ohem_block_threads(p)
    round_us = (round_chain_ms(b, threads, 200)
                - round_chain_ms(b, threads, 0)) / 200 * 1e3
    schedule = ohem_chain(args)
    empty = empty_launch_ms(b, 1, threads)
    res = {"probe": "small_kernels", "timing": DEVICE_TIMING + "; two readings",
           "ohem_B32_P3600": {
               "device_ms": [device_ms(lambda: ohem_select(*args, 1.0, 0.5, 16))
                             for _ in range(2)],
               "bound_ms": ohem_bound(b, p)[0],
               **event_and_plain(
                   lambda: ohem_select(*args, 1.0, 0.5, 16),
                   lambda: ohem_select_reference(*args, 1.0, 0.5, 16), 5),
               "block_threads": threads, "empty_launch_ms": empty,
               "block_round_us": round_us,
               "schedule_worst_sample": schedule,
               "block_rounds_floor_ms": (
                   empty + schedule["block_rounds"] * round_us * 1e-3)}}
    rng = np.random.RandomState(13)
    for name, *shape, shared in WINDOW_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            if name != "malf" and dtype == torch.float32:
                continue
            wargs = window_inputs(rng, *shape, shared, dtype) + [shape[-1]]
            row = {"device_ms": [device_ms(lambda: gather_windows(*wargs))
                                 for _ in range(2)]}
            if name == "malf" and dtype == torch.bfloat16:
                wb, _, num_lm, _, _, d, win = shape
                row["bound_ms"] = window_bound(wb, num_lm, d, win)[0]
                row.update(event_and_plain(
                    lambda: gather_windows(*wargs),
                    lambda: gather_windows_reference(*wargs), 20))
                row["empty_launch_ms"] = empty_launch_ms(wb * d, 1, 256)
                row.update(window_library(*wargs))
            res[f"window_{name}_{str(dtype).split('.')[-1]}"] = row
    res.update(probe_rasterizers())
    return res


def probe_rasterizers():
    """Device time of the two GT rasterizers at a train step's shape
    (``TRAIN_RASTER``; ``label_rows``'s rows and a train step's own), beside
    their bounds and empty launches of their grids, both maps in one launch,
    and the landmark kernel against the blocks it gives a patch."""
    import torch

    from densebox_tpu_torch import LabelCfg, malf_face
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.ops.kernels import labels as kl

    b, k, m, num_lm = TRAIN_RASTER
    rows, lm_rows = (torch.from_numpy(a).cuda() for a in label_rows(
        np.random.RandomState(17), b, k, m, num_lm))
    inv = 1.0 / LabelCfg().loc_norm
    box_bound, lm_bound = rasterizer_bounds(rows, lm_rows, m, num_lm)
    # an empty kernel of each grid (csrc/labels.cu: 256 threads; boxes:
    # tiles of 32 x 8 pixels, batch in y; landmarks: the chunks of a
    # patch's output, batch in y; both maps: the wider of the two grids
    # twice)
    box_blocks = -(-m // 32) * -(-m // 8)
    _, chunks = kl.landmark_chunk(m, num_lm, b)
    res = {
        "rasterize_boxes_B32_K16_M60": {
            "device_ms": [device_ms(lambda: kl.rasterize_boxes(rows, m, inv))
                          for _ in range(2)],
            "bound_ms": box_bound[0],
            "empty_launch_ms": empty_launch_ms(box_blocks, b, 256),
            **event_and_plain(
                lambda: kl.rasterize_boxes(rows, m, inv),
                lambda: kl.rasterize_boxes_reference(rows, m, inv))},
        "rasterize_landmarks_B32_K16_L5_M60": {
            "device_ms": [device_ms(
                lambda: kl.rasterize_landmarks(lm_rows, m, num_lm))
                for _ in range(2)],
            "bound_ms": lm_bound[0],
            "empty_launch_ms": empty_launch_ms(chunks, b, 256),
            **event_and_plain(
                lambda: kl.rasterize_landmarks(lm_rows, m, num_lm),
                lambda: kl.rasterize_landmarks_reference(lm_rows, m, num_lm))},
        "rasterize_maps_one_launch": {
            "device_ms": [device_ms(lambda: kl.rasterize_maps(
                rows, lm_rows, m, inv, num_lm)) for _ in range(2)],
            "empty_launch_ms": empty_launch_ms(2 * max(box_blocks, chunks),
                                               b, 256)}}
    # the rows a train step gives the kernels: a synthetic batch of the
    # malf_face() preset, packed
    cfg = malf_face()
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(20), b,
                            cfg.label, cfg.train.max_boxes, num_lm)
    step_rows = kl.pack_boxes(batch["boxes"], batch["box_valid"], cfg.label)
    step_lm_rows = kl.pack_landmarks(batch["boxes"], batch["box_valid"],
                                     batch["landmarks"], batch["lm_valid"],
                                     cfg.label)
    res["rows_of_a_train_step"] = {
        "boxes_valid": int(batch["box_valid"].sum()),
        "rasterize_boxes": [device_ms(
            lambda: kl.rasterize_boxes(step_rows, m, inv)) for _ in range(2)],
        "rasterize_landmarks": [device_ms(
            lambda: kl.rasterize_landmarks(step_lm_rows, m, num_lm))
            for _ in range(2)],
        "rasterize_maps_one_launch": [device_ms(
            lambda: kl.rasterize_maps(step_rows, step_lm_rows, m, inv, num_lm))
            for _ in range(2)]}
    per = m * m * num_lm
    sweep = {}
    for blocks in (3, 4, 5, 6, 8, 10, 15, 20):
        chunk = -(-per // blocks // 4) * 4
        with mock.patch.object(kl, "landmark_chunk",
                               lambda *a: (chunk, -(-per // chunk))):
            sweep[f"{-(-per // chunk)}_blocks_a_patch"] = device_ms(
                lambda: kl.rasterize_landmarks(lm_rows, m, num_lm))
    res["rasterize_landmarks_by_blocks"] = sweep
    return res


def bits(t):
    """``t``'s bits as integers, for a bit-for-bit comparison."""
    import torch

    t = t.contiguous()
    return t.view({1: torch.int8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def rolled(x, s: int):
    """``x`` with its batch rolled by ``s`` slots (image i in slot
    (i + s) % B), in x's memory format."""
    import torch

    out = torch.empty_like(x)
    out.copy_(torch.roll(x, s, 0))
    return out


def slot_dependence(op, *xs):
    """How ``op``'s output for each image of the batch ``xs`` depends on
    the image's slot: ``op(*xs)`` runs with the batch rolled by every s (so
    each image visits every slot, beside other neighbours), each output is
    rolled back and compared with roll 0's bit for bit. Returns how many
    (image, slot) pairs differ and how many elements, summed over the
    values when ``op`` returns a dict."""
    def outputs(s):
        out = op(*(rolled(x, s) for x in xs))
        out = out if isinstance(out, dict) else {"": out}
        return {k: bits(rolled(v, -s)) for k, v in out.items()}

    base = outputs(0)
    n = xs[0].shape[0]
    pairs, elems = 0, 0
    for s in range(1, n):
        differ = sum((v != base[k]).reshape(n, -1).sum(1)
                     for k, v in outputs(s).items())
        pairs += int((differ > 0).sum())
        elems += int(differ.sum())
    return {"pairs": pairs, "elements": elems}


def conv_variants():
    """Bodies of ``DenseBox._conv`` for the slot probe: as shipped (None),
    the plain cuDNN call, and ways around a slot dependence of cuDNN's
    kernels: an odd width (and height) padded by one zero column (row) and
    cropped, each image alone where the width is odd, NCHW memory."""
    import torch
    import torch.nn.functional as F

    def plain(self, conv, x):
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                        padding=conv.padding)

    def padded(pad_h):
        def body(self, conv, x):
            ph = x.shape[2] % 2 if pad_h else 0
            pw = x.shape[3] % 2
            if not (ph or pw):
                return plain(self, conv, x)
            xp = F.pad(x, (0, pw, 0, ph)).contiguous(
                memory_format=torch.channels_last)
            return plain(self, conv, xp)[:, :, :x.shape[2], :x.shape[3]]
        return body

    def split_odd(self, conv, x):
        if x.shape[3] % 2 == 0:
            return plain(self, conv, x)
        return torch.cat([plain(self, conv, x[i:i + 1])
                          for i in range(x.shape[0])])

    def nchw(self, conv, x):
        return plain(self, conv, x.contiguous())

    return {"shipped": None, "plain": plain, "pad_odd_w": padded(False),
            "pad_odd_hw": padded(True), "split_odd_w": split_odd,
            "nchw": nchw}


@contextlib.contextmanager
def cudnn_mode(flag: str):
    """cuDNN's ``benchmark`` or ``deterministic`` mode on, restored after."""
    import torch

    old = getattr(torch.backends.cudnn, flag)
    setattr(torch.backends.cudnn, flag, True)
    try:
        yield
    finally:
        setattr(torch.backends.cudnn, flag, old)


def probe_slot(name, model_cfg, infer_cfg, label_cfg, canvas, quant=None):
    """Which operations of a device call make an image's result depend on
    its slot in the batch. For each pyramid level, every operation of the
    forward (the resize; each convolution in every body of
    ``conv_variants`` and with cuDNN's benchmark or deterministic mode; the
    max-pools; the x2 upsample; the fused head products) runs alone on its
    recorded input under every roll of the batch (``slot_dependence``).
    Then, for each body, the whole forward's maps under every roll, the
    served check (each image's detections in its slot of the canvas batch
    against a detect of it alone in slot 0 of a zero batch) and the device
    call's time (CUDA events, 20 calls each in turns). An int8 model runs
    only the whole-forward part, as shipped."""
    import torch
    import torch.nn.functional as F

    from densebox_tpu_torch.device import reference_precision
    from densebox_tpu_torch.infer import detect_batch, pyramid_shapes
    from densebox_tpu_torch.infer.detector import pyramid_maps
    from densebox_tpu_torch.infer.resize import resize_linear
    from densebox_tpu_torch.models import densebox as mdb

    x = canvas.cuda()
    model = (init_quant_model(model_cfg, x, quant) if quant
             else init_model(model_cfg, "cuda"))
    infer_cfg = with_live_threshold(model, x, infer_cfg)
    dtype = model_cfg.compute_dtype
    variants = conv_variants()
    plain = variants["plain"]
    modules = dict(model.named_modules())
    res = {"probe": "slot", "cell": name, "batch": list(x.shape),
           "dtype": "int8" if quant else dtype, "levels": []}
    with torch.inference_mode():
        for hs, ws, _, _ in ([] if quant else
                             pyramid_shapes(*x.shape[1:3], infer_cfg.scales)):
            ops = {}
            if (hs, ws) != tuple(x.shape[1:3]):
                ops["resize"] = slot_dependence(
                    lambda b: resize_linear(b, (hs, ws)), x)
            taps = []
            names = {id(m): n for n, m in modules.items()}
            up_fn, pool_fn, heads = (mdb.upsample2x_align_corners,
                                     F.max_pool2d, model._heads)

            def rec_conv(conv, inp):
                taps.append((names[id(conv)], (inp,)))
                return plain(model, conv, inp)

            def rec_up(inp):
                taps.append(("upsample", (inp,)))
                return up_fn(inp)

            def rec_pool(inp, *a):
                taps.append(("maxpool", (inp,)))
                return pool_fn(inp, *a)

            def rec_heads(f3, up, *a):
                taps.append(("heads", (f3, up)))
                return heads(f3, up, *a)

            with mock.patch.object(model, "_conv", rec_conv), \
                    mock.patch.object(model, "_heads", rec_heads), \
                    mock.patch.object(mdb, "upsample2x_align_corners",
                                      rec_up), \
                    mock.patch.object(F, "max_pool2d", rec_pool):
                model(resize_linear(x, (hs, ws)))
            for tap, inp in taps:
                key = f"{tap}@{list(inp[-1].shape[1:])}"
                with reference_precision(dtype):
                    if tap == "upsample":
                        ops[key] = slot_dependence(up_fn, *inp)
                    elif tap == "maxpool":
                        ops[key] = slot_dependence(
                            lambda b: pool_fn(b, 2, 2), *inp)
                    elif tap == "heads":
                        ops[key] = slot_dependence(
                            lambda f, u: heads(f, u, False, None, None), *inp)
                    else:
                        conv = modules[tap]
                        ops[key] = {
                            v: slot_dependence(
                                lambda b: body(model, conv, b), *inp)
                            for v, body in variants.items() if body}
                        for flag in ("benchmark", "deterministic"):
                            with cudnn_mode(flag):
                                ops[key][f"cudnn_{flag}"] = slot_dependence(
                                    lambda b: plain(model, conv, b), *inp)
            del taps
            res["levels"].append({"hw": [hs, ws], "ops": ops})

        def patched(vname):
            body = variants[vname]
            return (contextlib.nullcontext() if body is None else
                    mock.patch.object(type(model), "_conv", body))

        whole = {}
        for vname in (["shipped"] if quant else variants):
            with patched(vname):
                maps = slot_dependence(
                    lambda b: {f"{i}.{k}": v for i, (m, _) in enumerate(
                        pyramid_maps(model, b, infer_cfg)) for k, v in
                        m.items()}, x)
                full = detect_batch(model, x, infer_cfg, label_cfg)
                differ = []
                for i in range(x.shape[0]):
                    alone = torch.zeros_like(x)
                    alone[0] = x[i]
                    one = detect_batch(model, alone, infer_cfg, label_cfg)
                    v = full["valid"][i]
                    if not (torch.equal(v, one["valid"][0]) and all(
                            torch.equal(full[k][i][v], one[k][0][v])
                            for k in full if k != "valid")):
                        differ.append(i)
                whole[vname] = {"maps": maps, "detections": int(
                    full["valid"].sum()), "images_not_as_alone": differ}
        times = {k: [] for k in whole}
        for _ in range(2):
            for vname in list(whole) + list(whole)[::-1]:
                with patched(vname):
                    times[vname] += event_seconds(
                        lambda: detect_batch(model, x, infer_cfg, label_cfg),
                        5)
        for vname in whole:
            whole[vname]["device_call_ms"] = quartiles(
                np.asarray(times[vname]) * 1e3)
        res["whole"] = whole
    return res


# layers of the qconv probe that are also timed at B = 1 .. 32
SCALED_LAYERS = ("turbo_conv1_2", "turbo_conv3_2", "turbo_conv4_2",
                 "turbo_head_conv1")
GROUPS = ("fused_conv", "resize", "qconv", "determinism", "export",
          "small_kernels", "slot", "nms")


def slot_cells():
    """The cells of the ``slot`` probe as (name, model, infer and label
    configs, int8 chain or None): paper bf16, malf_face() bf16, paper f32
    (kitti_vehicle() at full width), turbo_int8 and turbo_int8_lm4."""
    from densebox_tpu_torch import kitti_vehicle

    (_, paper, p_infer, label), (_, turbo, t_infer, _) = serving_cells()
    (malf, *malf_cfgs, _), (lm4, *lm4_cfgs, _) = landmark_cells()
    return [("paper", paper, p_infer, label, None),
            (malf, *malf_cfgs, None),
            ("paper_f32", kitti_vehicle().model, p_infer, label, None),
            ("turbo_int8", turbo, t_infer, label, "fused"),
            (lm4, *lm4_cfgs, "fused")]


def slot_canvas(canvas_hw=(480, 640), n=8):
    """``n`` served requests' images (chip_smoke.py's), letterboxed into a
    canvas batch."""
    import torch

    x = np.zeros((n,) + tuple(canvas_hw) + (3,), np.float32)
    for i, img in enumerate(request_images(n, canvas_hw, seed=3)):
        x[i, :img.shape[0], :img.shape[1]] = img
    return torch.from_numpy(x)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5,
                    help="calls in each profiler trace of the export probe")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups of probes to run: "
                         + ", ".join(GROUPS))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes a subset of {GROUPS}")
    # cuBLAS reads it when its handle is made; PyTorch's deterministic mode
    # asks for it (probe ``determinism``)
    if "determinism" in only:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is false; this "
              "script runs only on a CUDA card", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    host = torch.from_numpy(np.random.RandomState(0).rand(*CANVAS)
                            .astype(np.float32)).pin_memory()
    cells = serving_cells()
    _, paper, paper_infer, _ = cells[0]
    if "fused_conv" in only:
        emit(probe_fused_conv(paper))
    if "resize" in only:
        emit(probe_resize(paper_infer, host))
    if "qconv" in only:
        emit(probe_qconv())
        emit(probe_requant())
        emit(probe_neck())
    if "determinism" in only:
        for (preset, cfg), cell in zip(train_cfgs(),
                                       ("train_paper", "train_malf")):
            emit(probe_determinism(cell, cfg, preset == "malf_face"))
            torch.cuda.empty_cache()
    if "export" in only:
        for name, quant, cfgs in (("turbo_int8", "fused", cells[1][1:]),
                                  ("paper", None, cells[0][1:])):
            emit(probe_export(name, *cfgs, host, args.calls, quant))
    if "small_kernels" in only:
        emit(probe_small_kernels())
    if "nms" in only:
        emit(probe_nms())
    if "slot" in only:
        for cell in slot_cells():
            emit(probe_slot(*cell[:4], slot_canvas(), quant=cell[4]))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
