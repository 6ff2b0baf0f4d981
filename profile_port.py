#!/usr/bin/env python3
"""Where a device call of the port's serving path, and a train step, spend
their time.

    python3 profile_port.py [--calls 5] [--only int8,qconv]   # repository root, one CUDA card

Prints one JSON line per probe, after the card's name and power limit:
  cell        for each serving cell of chip_smoke.py (paper and turbo, B=8,
              480x640 canvas, bf16, random weights), for turbo_int8 and
              turbo_int8_hybrid (the turbo model in int8, calibrated on the
              profiled batch; fused and hybrid chain) and for its landmark
              cells malf_bf16 and turbo_int8_lm4: a device call
              (pinned host batch -> detect -> results on the host) on the
              host clock around a synchronised call (median, q1, q3 of
              20), then a
              torch.profiler trace of --calls calls: kernel time by kind,
              the top kernels, and the device's idle share (1 - kernel time
              / wall time of the traced calls);
  train       for the two train cells (chip_smoke.py's phases 20 and 21:
              train_paper = kitti_vehicle(), train_malf = malf_face() through
              the canvas step; full width, f32 with TF32 off, B=32, 240 px
              patches, synthetic batches drawn on the card): a step on the
              host clock around a synchronised step (median, q1, q3 of 10),
              then a trace of --calls steps: kernel time by kind (forward
              and backward convolutions, GEMMs, elementwise, the rasterizer
              and OHEM kernels, the optimizer's foreach kernels) and the
              idle share; the same two cells again with compute_dtype
              bfloat16 (float32 parameters cast at use);
  fused_conv  the paper model's conv1_2 at B=8, 480x640, bf16: nn.Conv2d
              and ReLU as the model runs them, against cuDNN's fused
              conv+bias+ReLU (torch.cudnn_convolution_relu), by CUDA events,
              alternated, with the largest difference of their outputs;
  resize      infer/resize.py's einsum form against batched products on
              NHWC as it lies, at each level of the paper cell's pyramid;
  qconv       the int8 conv kernel alone: device time (CUDA-graph replay) of
              every conv shape of the turbo int8 model at B=8, their sum
              over the 14 launches of a device call, four of them at B = 1
              to 32 (the cost of a launch and of a round of tiles), and the
              paper-width int8 forward (B=2, 240x320) on the host clock with
              its kernel time by kind. Uses only ``qconv_int8`` and ``QuantDenseBox``,
              so the same script times an older tree of the package.
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
  export      for turbo_int8 and paper (B=8, 480x640): a device call as in
              ``cell`` through the live path, through the live path with
              the custom-op dispatch taken out (each wrapper calling its
              CUDA launch directly) and through the artifact
              (``export.py``, exported and loaded here), 20 calls each in
              turns (live, direct, artifact, artifact, direct, live) x 2,
              median (q1, q3); then a trace of --calls artifact calls;
  small_kernels  ``ohem_select`` (B=32, P=3600, errors of the paper model's
              forward), ``gather_windows`` (the MALF serve shape, bf16 and
              f32) and the two GT rasterizers (B=32, K=16, M=60, L=5) by
              device time (CUDA-graph replay), two readings each; for a
              package that has it, both maps in one launch and the landmark
              kernel against its blocks a patch. Uses only the wrappers, so
              the same script times an older tree of the package;
``--only`` takes a comma-separated subset of the groups serve (paper,
turbo), int8 (turbo_int8, turbo_int8_hybrid), lm (malf_bf16,
turbo_int8_lm4), train, fused_conv, resize, qconv, determinism, export,
small_kernels; the default is all.
Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
import warnings
from unittest import mock

import numpy as np

from chip_smoke import (QCONV_CASES, RASTER_CASES, TURBO_LAUNCHES,
                        WINDOW_CASES, card_line, device_ms, emit, init_model,
                        init_quant_model, label_rows, landmark_cells,
                        median_ms, ohem_forward_case, qconv_inputs,
                        serving_cells, train_cfgs, window_inputs,
                        with_live_threshold)

CANVAS = (8, 480, 640, 3)


def kernel_kind(name: str) -> str:
    """Bucket of a CUDA kernel (or copy) by its name in the trace."""
    n = name.lower()
    for kind, keys in (
            ("nms_kernel", ("iou_mask", "sweep_kernel")),
            ("int8_conv_kernel", ("qconv_kernel", "qconv_mma_kernel",
                                  "qconv_dp4a_kernel")),
            ("requant_kernel", ("requant_kernel",)),
            ("window_kernel", ("window_rows_kernel", "window_elem_kernel",
                               "window_kernel")),
            ("rasterizer_kernel", ("boxes_kernel", "landmarks_kernel",
                                   "maps_kernel")),
            ("ohem_kernel", ("ohem_kernel",)),
            ("optimizer", ("multi_tensor_apply",)),
            ("sort", ("sort", "radix")),
            ("max_pool", ("max_pool",)),
            ("relu", ("clamp",)),
            ("add", ("functor_add",)),        # mostly nn.Conv2d's bias
            ("conv_backward", ("dgrad", "wgrad", "bprop", "backward_data",
                               "backward_filter", "bwd")),
            ("conv", ("conv", "cudnn", "implicit", "xmma_fprop")),
            ("gemm", ("gemm", "cutlass", "matmul", "nvjet")),
            ("copy", ("memcpy", "memset")),
            ("elementwise", ("vectorized_elementwise_kernel",
                             "native::elementwise_kernel",
                             "unrolled_elementwise_kernel"))):
        if any(k in n for k in keys):
            return kind
    return "other"


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
    call, kernel time by kind, the top kernels and the device's idle
    share."""
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
            "device_idle_share": 1 - kernel * calls / wall,
            "kernel_ms_per_call_by_kind": by_kind,
            "top_kernels_ms_launches_per_call": sorted(top)[::-1][:12]}


def probe_cell(name, model_cfg, infer_cfg, label_cfg, host, calls,
               quant=None, loc_bias=0.0):
    from densebox_tpu_torch.infer import make_detect_fn

    model = (init_quant_model(model_cfg, host.cuda(), quant, loc_bias=loc_bias)
             if quant else init_model(model_cfg, "cuda", loc_bias=loc_bias))
    infer_cfg = with_live_threshold(model, host.cuda(), infer_cfg)
    detect = make_detect_fn(model, infer_cfg, label_cfg)

    def call():
        out = detect(host.to("cuda", non_blocking=True))
        return {k: v.cpu() for k, v in out.items()}

    res = {"probe": "cell", "cell": name, "device_call_ms": host_ms(call, 20)}
    res.update(trace_calls(call, calls))
    return res


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


def probe_train(name, cfg, canvas, calls):
    """A train cell: the step of chip_smoke.py's phase 20 (patch batches) or
    21 (``canvas``: 480 px canvases, patches sampled on the card)."""
    import torch

    from densebox_tpu_torch import DenseBox
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.train import (create_train_state,
                                          make_canvas_train_step,
                                          make_train_step)

    data_label = (dataclasses.replace(cfg.label, patch_size=480) if canvas
                  else cfg.label)
    model = DenseBox(cfg.model)
    state = create_train_state(model, cfg)
    step = (make_canvas_train_step if canvas else make_train_step)(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def call():
        batch = synthetic_batch(gen, cfg.train.batch_size, data_label,
                                cfg.train.max_boxes, cfg.model.num_landmarks)
        return step(state, batch)[1]

    call()                                   # cuDNN picks its algorithms
    res = {"probe": "train", "cell": name,
           "compute_dtype": cfg.model.compute_dtype,
           "batch": cfg.train.batch_size, "patch": cfg.label.patch_size,
           "canvas": 480 if canvas else None, "step_ms": host_ms(call, 10)}
    res["steps_per_s"] = 1e3 / res["step_ms"][0]
    res.update(trace_calls(call, calls))
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return res


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
    int8 model (B=8, in the mode the model runs the layer in), and the
    paper-width int8 forward."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.ops.kernels.qconv import qconv_int8

    rng = np.random.RandomState(5)
    layers = {}
    for name, *shape in QCONV_CASES:
        if name not in TURBO_LAUNCHES:
            continue
        x, wq, scale, bias, osc = qconv_inputs(rng, *shape, "cuda")
        kw = dict(relu=False) if shape[4] <= 4 else dict(out_scale=osc)
        layers[name] = [device_ms(lambda: qconv_int8(x, wq, scale, bias, **kw))
                        for _ in range(2)]
    per_call = sum(min(v) * TURBO_LAUNCHES[k] for k, v in layers.items())
    # device time against the batch: what a launch costs before its first
    # tile is done, and what each further round of tiles adds
    scaling = {}
    for name, *shape in QCONV_CASES:
        if name not in SCALED_LAYERS:
            continue
        for b in (1, 2, 4, 8, 16, 32):
            x, wq, scale, bias, osc = qconv_inputs(rng, b, *shape[1:], "cuda")
            scaling.setdefault(name, {})[f"B{b}"] = device_ms(
                lambda: qconv_int8(x, wq, scale, bias, out_scale=osc))
    cfg = dataclasses.replace(kitti_vehicle().model, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 240, 320, 3)
                         .astype(np.float32)).cuda()
    model = init_quant_model(cfg, x)

    def call():
        with torch.inference_mode():
            return model(x)

    res = {"probe": "qconv", "batch": 8, "device_ms_two_readings": layers,
           "per_device_call_14_launches_ms": per_call,
           "device_ms_by_batch": scaling,
           "paper_int8_forward": {"input": list(x.shape),
                                  "forward_ms": host_ms(call, 10)}}
    res["paper_int8_forward"].update(trace_calls(call, 3))
    return res


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


def probe_small_kernels():
    """Device time of the OHEM and window-gather kernels at the main path's
    shapes, through their wrappers alone."""
    import torch

    from densebox_tpu_torch.ops.kernels.ohem import ohem_select
    from densebox_tpu_torch.ops.kernels.window import gather_windows

    args = ohem_forward_case(32)
    res = {"probe": "small_kernels", "timing": "device time: 20 launches "
           "replayed as a CUDA graph between one pair of events, median of 5",
           "ohem_B32_P3600": [device_ms(
               lambda: ohem_select(*args, 1.0, 0.5, 16)) for _ in range(2)]}
    rng = np.random.RandomState(13)
    name, *shape, shared = WINDOW_CASES[0]
    for dtype in (torch.bfloat16, torch.float32):
        wargs = window_inputs(rng, *shape, shared, dtype) + [shape[-1]]
        res[f"window_{name}_{str(dtype).split('.')[-1]}"] = [
            device_ms(lambda: gather_windows(*wargs)) for _ in range(2)]
    res.update(probe_rasterizers())
    return res


def probe_rasterizers():
    """Device time of the two GT rasterizers at the training shape (B=32,
    K=16, M=60, L=5; ``chip_smoke.py``'s rows), through their wrappers alone;
    where the package has them, also both maps in one launch and the landmark
    kernel against the blocks it gives a patch."""
    import torch

    from densebox_tpu_torch import LabelCfg, malf_face
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.ops.kernels import labels as kl

    _, b, k, m, num_lm = RASTER_CASES[0]
    rows, lm_rows = (torch.from_numpy(a).cuda() for a in label_rows(
        np.random.RandomState(17), b, k, m, num_lm))
    inv = 1.0 / LabelCfg().loc_norm
    res = {"rasterize_boxes_B32_K16_M60": [device_ms(
               lambda: kl.rasterize_boxes(rows, m, inv)) for _ in range(2)],
           "rasterize_landmarks_B32_K16_L5_M60": [device_ms(
               lambda: kl.rasterize_landmarks(lm_rows, m, num_lm))
               for _ in range(2)]}
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
            for _ in range(2)]}
    if not hasattr(kl, "rasterize_maps"):
        return res
    res["rows_of_a_train_step"]["rasterize_maps_one_launch"] = [device_ms(
        lambda: kl.rasterize_maps(step_rows, step_lm_rows, m, inv, num_lm))
        for _ in range(2)]
    res["rasterize_maps_one_launch"] = [device_ms(
        lambda: kl.rasterize_maps(rows, lm_rows, m, inv, num_lm))
        for _ in range(2)]
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


# layers of the qconv probe that are also timed at B = 1 .. 32
SCALED_LAYERS = ("turbo_conv1_2", "turbo_conv3_2", "turbo_conv4_2",
                 "turbo_head_conv1")
GROUPS = ("serve", "int8", "lm", "train", "fused_conv", "resize", "qconv",
          "determinism", "export", "small_kernels")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=5,
                    help="device calls in each cell's profiler trace")
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
    # as chip_smoke.py's serve phases run: f32 at full precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    host = torch.from_numpy(np.random.RandomState(0).rand(*CANVAS)
                            .astype(np.float32)).pin_memory()
    cells = serving_cells()
    if "serve" in only:
        for name, *cfgs in cells:
            emit(probe_cell(name, *cfgs, host, args.calls))
    _, turbo, turbo_infer, label = cells[1]
    if "int8" in only:
        for name, quant in (("turbo_int8", "fused"),
                            ("turbo_int8_hybrid", "hybrid")):
            emit(probe_cell(name, turbo, turbo_infer, label, host, args.calls,
                            quant=quant))
    if "lm" in only:
        for name, *cfgs, quant in landmark_cells():
            emit(probe_cell(name, *cfgs, host, args.calls, quant=quant,
                            loc_bias=1.0))
    if "train" in only:
        for dtype in ("float32", "bfloat16"):
            for (preset, cfg), cell in zip(train_cfgs(),
                                           ("train_paper", "train_malf")):
                cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                    cfg.model, compute_dtype=dtype))
                emit(probe_train(cell, cfg, preset == "malf_face", args.calls))
                torch.cuda.empty_cache()
    _, paper, paper_infer, _ = cells[0]
    if "fused_conv" in only:
        emit(probe_fused_conv(paper))
    if "resize" in only:
        emit(probe_resize(paper_infer, host))
    if "qconv" in only:
        emit(probe_qconv())
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
