#!/usr/bin/env python3
"""Drive the PyTorch port's detect-and-serve and train paths, and its command
line, once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises, so the exit code is
not 0):
  1. no card, no run: without CUDA the script exits 1 with no result;
  2. the card's name and power limit (nvidia-smi);
  3. build the CUDA kernels (NMS, int8 conv, requant, window gather, GT
     rasterizers, OHEM, the int8 neck) from densebox_tpu_torch/csrc, one
     nvcc per source, all at once;
  4. the paper model (width 1.0) forward in f32 on the card against the
     port on the CPU (1e-3 absolute), then a bf16 forward;
  5. serve: a DetectServer with the paper model in bf16, 480x640 canvas,
     max_batch 8, the preset's 4-scale pyramid; 24 requests from 8 threads,
     answered, coalesced, and each equal bit for bit to a direct
     detect_batch of its image alone in slot 0 of a zero batch of 8, as
     is each of the first 8 images detected in its slot of a batch of 8
     different images (``DenseBox._conv`` runs a batch that cuDNN would
     compute differently by slot one image a call: the bf16 512-channel
     convs at the 0.7071 and 0.3536 levels);
  6. the same serve run with the turbo trunk (s2d4, depth 3, width 0.25);
  7. the paper model in int8, calibrated on the card: its forward on the
     card against the plain versions on the CPU with the same int8 state
     (B=2, 240x320): every int8 code and map identical; the fused and the
     hybrid chain identical on the card; the forward's time on the card;
  8. serve the turbo model in int8 (calibrated on the card from the canvas
     batch, one scale), as phase 6: served equal to alone, one int8 conv
     launch per conv per device call, all 14 on the tensor-core variant,
     one NMS and one int8 neck launch per device call;
  9. the same with the hybrid chain (int32 conv, then requant);
 10. landmark decode, card against CPU: the malf_face() model (width 1.0,
     5 landmarks, refine) in bf16 runs its 5-scale pyramid once on the card
     (B=2, 240x320); everything after the forward (decode, cap, NMS, scale
     selection, landmark decode) then runs on those maps on the card and on
     the CPU: boxes, scores, validity and landmarks identical, and the
     'std' scale selection counted where it differs;
 11. serve malf_face() in bf16 (480x640 canvas, max_batch 8, its pyramid
     and anchors, lm_topk 64), as phase 5: served equal to a direct
     detect_batch of the image alone bit for bit, landmarks included; one
     NMS and one window launch per device call;
 12. serve the bench's landmark pipeline in int8: the turbo trunk with 4
     landmarks and refine, no anchors (shared origins), calibrated on the
     card, one scale: as phase 11, plus one int8 conv launch per conv;
 13. one train step, card against CPU: kitti_vehicle() and malf_face() at
     full width in f32, B=4, 240 px, the same state, batch and given draws:
     GT maps identical, OHEM masks identical on the same errors, loss and
     metrics within 1e-4 relative, every gradient within 5e-3 of its largest
     entry (cuDNN sums in another order than the CPU; a float64 step on the
     CPU shows float32's own rounding noise beside it); then the step at
     B=32 (malf_face through the canvas step) taken twice from the same
     parameters, momentum and generator state: parameters, momentum, loss
     and update norm identical bit for bit; ms/step with the step's cuDNN
     pinning and with it taken out, in turns;
 14. train kitti_vehicle() at full width, B=32, 240 px patches: 2 + 30
     steps of make_train_step on synthetic batches drawn on the card; every
     loss and update norm finite, the mean loss of the last 5 steps below
     that of the first 5, parameters moved, per step 1 box-rasterizer
     launch, 0 landmark launches and 1 OHEM launch; ms/step and steps/s on
     the host clock (synchronised) on a line of their own;
 15. train malf_face() at full width (5 landmarks, refine) through
     make_canvas_train_step: 480 px canvases, 240 px patches sampled on the
     card with flips, B=32, 2 + 12 steps: as phase 14, with 1 + 1 rasterizer
     launches (one launch for the two maps) and 2 OHEM launches per step;
 16. ``fit`` on kitti_vehicle() at full width, B=32, 240 px, on the card by
     default, a step-keyed stream of synthetic batches, a temporary workdir
     (log every 4, checkpoint every 2, keep 2): 8 steps straight against 4
     steps, a restart from the checkpoint into a new model, and 4 more:
     parameters, momentum, loss and update norm bit-equal; the same restart
     with ``run_salt=1`` differs; two checkpoint files are left;
     ``load_for_inference`` of the last one gives a model whose
     ``detect_batch`` equals the trained model's; one box-rasterizer and
     one OHEM launch per step; ms/step through ``fit`` with those
     boundaries (set-up included) and without a workdir from a state made
     beforehand, the set-up's and one checkpoint write's time, beside the
     card;
 17. the command line (``densebox_tpu_torch/cli.py``) as a user runs it, on
     a KITTI-format directory written here: 64 PNG scenes at KITTI's
     375 x 1242 (this script's own PNG writer, filter 0) with 1-6
     Car/Van/Truck boxes each plus DontCare lines. ``train`` in-process at
     the CLI's defaults (full-width kitti_vehicle, f32, B=32, 240 px patches
     from 384 x 1248 canvases), 12 steps, a checkpoint every 6: rc 0, the
     logged losses finite, two checkpoints, 12 box-rasterizer and 12 OHEM
     launches, the loader's backend and how many steps waited on it, ms/step
     beside phase 14's; the loader alone (batches/s, with the decoder the
     machine has and with cv2 hidden); ``eval --protocol kitti`` at a
     threshold from the model's score map: its summary, ``n_gt`` equal to
     the boxes written, one NMS launch per device call and every call's
     detections equal to a direct ``detect_batch`` of the same canvas
     batch; ``quantize --calib-dir`` and ``detect`` of 8 files on the int8
     workdir with cv2 hidden: one ``qconv_int8`` launch per conv per pyramid
     level per image, each on the variant ``kernel_variant`` names, the
     KITTI files written, the note that no annotated image was; ``python3
     -m densebox_tpu_torch.cli serve`` as a subprocess: /healthz within 120
     s, 8 PNG bodies posted one at a time each answered as a direct
     detect of its image alone in slot 0, and for the first two the card's
     maps of that call within 1e-4 of the CPU's and their decode on the
     CPU equal to the answer, 413 and 400, /healthz counting 8,
     SIGINT ending it with rc 0, the latency quartiles on a line of their
     own; and ``train --landmarks 4`` (width 0.25, 4 steps) then ``detect``
     of 4 images: one window and one NMS launch per device call, finite
     landmarks. The phase's time closes it;
 18. multi-device (``parallel/``), kitti_vehicle() at full width, f32: (a)
     a one-rank NCCL group in this process: the sharded train step
     at B=32, 240 px equal bit for bit to the bare step of the same state,
     batch and draws (parameters, momentum, every metric), with one
     box-rasterizer and one OHEM launch; both timed in turns;
     ``fit(use_mesh=True)`` 8 steps with checkpoints, ms/step; (b)
     two and four processes sharing the one card over a gloo group on CUDA
     tensors (NCCL refuses two ranks on one device): gloo's all_reduce
     (f32, f64) and broadcast on CUDA tensors checked, then DP 2 and DP x
     TP 2 x 2 steps on the same B=32 global batch against the bare step
     (parameters within 2e-6, loss within 1e-5, counts equal, ranks
     bit-equal), one box-rasterizer and one OHEM launch per rank, ms/step
     while sharing the card (contention, not scaling); a ``SpatialDenseBox``
     detect of a B=2 batch of 384 x 1248 canvases at the preset's 4 scales
     over the 2 and 4 ranks: scale-1 maps within 2e-5 of the local forward,
     the same valid slots, boxes within 1e-3, one NMS launch per rank; (c)
     ``torchrun --standalone --nproc_per_node 1 -m densebox_tpu_torch.cli
     train --synthetic`` (NCCL, world 1), 3 steps and a checkpoint;
 19. the turbo_int8 cell (B=8, 480 x 640, one scale) with
     ``QuantDenseBox(backend='xla')`` (the JAX package's default chain):
     every int8 code, int32 accumulator and map on the card equal to the
     CPU's; 14 ``qconv_int8`` launches per device call, all in int32 mode,
     no ``requant_epilogue``; the device call of 'fused' and 'xla' timed in
     turns, median (q1, q3);
 20. export (``densebox_tpu_torch/export.py``) of the turbo_int8, paper and
     malf_bf16 cells at B=8, 480 x 640: first a trace in a process whose
     constant caches were emptied, after which the live detect is unchanged
     and no int8 epilogue vector was kept; then export, save, reload: the
     artifact's detections equal the live ``detect_batch`` of the same
     batch bit for bit, and each of its slots the live detect of that
     image alone in slot 0, with the same launches per call (1 NMS; 14
     ``qconv_int8``, all on the tensor cores; 1 window gather), with the
     export, save and load seconds, the artifact's size and the device-call
     time of artifact and live path (CUDA events, in turns, median (q1,
     q3)); the turbo_int8 artifact loaded in a fresh process where
     ``densebox_tpu`` and ``jax`` cannot be imported and every model
     forward and ``detect_batch`` raise, equal to this process's answer;
     ``cli train`` (1 step), ``cli export`` and ``python3 -m
     densebox_tpu_torch.cli serve --artifact`` as a subprocess: 4 PNG
     requests, each equal to a direct detect of the checkpoint's model;
 21. precision: the port computes at the reference's precision by itself
     (``device.reference_precision``), and this script sets none of torch's
     precision flags; the phase starts with them as torch starts. (a)
     kitti_vehicle() at full width in f32 (B=2 on the 384 x 1248 canvas,
     its 4 scales), ``detect_batch`` and ``cli detect`` of an f32
     checkpoint (two 375 x 1242 PNG files) on the card against the CPU:
     every map within 1e-4, and the decode of the card's maps on the CPU
     equal to the card's detections (boxes, scores, keep sets); (b) ``cli
     detect --quantize`` of the same files on the card: every int8 code and
     output of the 'fused' chain (the CLI's) equal to the CPU's on the same
     int8 state and the same level inputs (the card's resized batches; the
     elements where the CPU's own resize differs are counted), and the
     'xla' chain's too, and the card's maps decoded on the CPU equal to the
     CLI's detections; (c) the f32 train step (kitti_vehicle, B=32, 240 px)
     on the card against the CPU, every gradient within 5e-3 of its
     largest entry; (d) what the precision costs: ms/step of that step and
     the device time of the paper-width f32 detect call (B=8, 480 x 640, 4
     scales) at the port's precision and with TF32 forced on, in turns,
     median (q1, q3); and the bf16 x2 upsample (the bf16 paper model's at
     480 x 640 and on the KITTI canvas) against the CPU's: as cuBLAS's
     bf16 GEMM with and without its reduced bf16 reduction (counted), and
     as the port takes it (float32 products rounded once: equal); the int8
     chain's upsample runs inside the int8 neck kernel, whose codes in the
     turbo model's forward equal the plain version's on the CPU from the
     same inputs;
 22. certification: ``python -m densebox_tpu_torch.certify`` as a
     subprocess for fast-s2d2-w0.5-lm4 at 200 steps and 2 eval batches:
     one JSON row with finite AP@0.50 in bf16 and int8 and a finite
     landmark error distribution, and its wall time;
 23. the port's bench and load test, as a user runs them: ``python -m
     densebox_tpu_torch.bench`` (through its ``main`` in this process, so
     that the kernels' counters are readable) at 480 x 640 for turbo int8
     at B=256 (the README's headline command), fast int8 at B=128 on the
     fused and the hybrid chain, paper bf16 at B=64, turbo int8 with 4
     landmarks at B=256, and ``--mode train`` at turbo's B=256 with 240 px
     patches, without and with landmarks: each last line and info line
     printed, the checksum finite, the kernel launches of one pass as the
     model predicts; one bench call of turbo int8 at B=256 equal bit for bit
     to ``detect_batch`` of its batch; ``python -m
     densebox_tpu_torch.loadtest --turbo-int8 --clients 1 8 16 32``: one
     line a client count, every request answered, fewer device calls than
     requests from 8 clients on (one client's every request is a call of
     its own), every answer equal to a detect of its image alone in slot 0
     of a zero batch, one NMS and 14 ``qconv_int8`` launches per device
     call (warm-ups included);
 24. the kernels against their plain versions, once at the main path's
     shapes (``kernel_cases.py``): each kernel through its wrapper on card
     tensors, bit for bit against its plain version on the same tensors:
     NMS at every (B, K) the main path calls (random set); ``qconv_int8``
     at every conv shape of the turbo int8 model (B=8, in the mode the model
     runs it, on the variant ``kernel_variant`` names) and at kitti's
     offline shapes (B=64, two rows compared); ``requant_epilogue`` at the
     accumulators of a hybrid call's 14 launches; ``gather_windows`` at the
     MALF and lm4 shapes in bf16; both rasterizers alone and in one launch
     at a train step's shape; ``ohem_select`` on the errors of a forward
     (B=32, P=3600); the int8 neck at kitti's four scales, B=8 and 64, at
     two output scales. Then the kernels line: each kernel's launches in
     the main-path run that drives it (counted in that run's phase, its
     counters zeroed just before) and its bound at the shape of its row in
     PERF.md's table of kernels.
At the end torch's three precision flags read as they did at the start.
Each serve and train run resets every kernel's launch counter just before
its requests or steps and reads them just after. The line before the last
is the script's seconds; the last line is {"ok": true, "device": {...}}.

This script drives the program's entry points end to end and checks each
kernel once at the main path's shapes (phase 24). The gpu-marked tests
(``tests/test_torch_kernels.py``, ``tests/test_torch_neck.py``) hold each
kernel to its plain version on its edge cases too, and ``profile_port.py``
(groups ``nms``, ``qconv``, ``small_kernels``) times them.

Weights are random (torch.Generator seeds), so detections are not
meaningful objects: the score threshold of the serve phases is set from
the model's own score map (the refine branch's, where it has one) so that
candidates reach NMS, and the landmark phases give the loc head a bias of
one so that boxes span a few map pixels (near-zero random loc maps give
boxes of a pixel, whose landmarks all take the centre fallback).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

from kernel_cases import (KITTI_OFFLINE, NMS_SHAPES, QCONV_CASES, TRAIN_RASTER,
                          TURBO_LAUNCHES, WINDOW_CASES, label_rows,
                          neck_bound, neck_levels, nms_bound, nms_set,
                          ohem_bound, ohem_forward_case, qconv_bound,
                          qconv_inputs, rasterizer_bounds, requant_bound,
                          window_bound, window_inputs)

REPO = os.path.dirname(os.path.abspath(__file__))
# csrc/<name>.cu of the program's kernels
KERNELS = ("nms", "qconv", "requant", "window", "labels", "ohem", "neck")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_seconds(fn, reps: int):
    """Device time of each of ``reps`` calls by CUDA events around it,
    after a warm-up, in seconds."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return res.stdout.strip().splitlines()[0]


def phase_build():
    from densebox_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:     # one nvcc per source
        libs = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    for name, lib in libs.items():
        build.load(name)
        log = lib.with_suffix(".log").read_text().splitlines()
        emit({"phase": "build", "kernel": name,
              "seconds_all": time.perf_counter() - t0,
              "ptxas": [ln.strip() for ln in log
                        if "registers" in ln or "Compiling entry" in ln]})


def float_state(cfg, seed=0, loc_bias=0.0):
    """Random float weights of ``cfg``; ``loc_bias`` is added to the loc
    head's output bias (the landmark phases' box size, see the docstring)."""
    import torch

    from densebox_tpu_torch.models import init_params

    sd = init_params(cfg, torch.Generator().manual_seed(seed))
    sd["loc.loc_conv2.bias"] += loc_bias
    return sd


def init_model(cfg, device, seed=0, loc_bias=0.0):
    from densebox_tpu_torch.models import DenseBox

    model = DenseBox(cfg, device=device)
    model.load_state_dict(float_state(cfg, seed, loc_bias))
    return model.eval()


# a bf16 server holds its weights in bf16 too (no cast per forward)
BF16 = dict(compute_dtype="bfloat16", param_dtype="bfloat16")


def serving_cells():
    """The two serving configurations as (name, model, infer and label
    configs): the paper preset at full width with its 4-scale pyramid, and
    the turbo trunk at scale 1.0, both in bf16."""
    from densebox_tpu_torch import ModelCfg, kitti_vehicle

    preset = kitti_vehicle()
    paper = dataclasses.replace(preset.model, **BF16)
    turbo = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.25, **BF16)
    return [("paper", paper, preset.infer, preset.label),
            ("turbo", turbo, dataclasses.replace(preset.infer, scales=(1.0,)),
             preset.label)]


def landmark_cells():
    """The two landmark serving configurations as (name, model, infer and
    label configs, int8 chain or None): the MALF face preset at full width
    in bf16 with its 5-scale pyramid and 5-point anchors, and the JAX
    bench's landmark pipeline (``bench.py --landmarks 4``: the turbo trunk
    with 4 landmarks and refine, ``LabelCfg()`` without anchors) in int8 at
    one scale."""
    from densebox_tpu_torch import LabelCfg, ModelCfg, kitti_vehicle, malf_face

    malf = malf_face()
    turbo_lm4 = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.25,
                         num_landmarks=4, use_refine=True, **BF16)
    return [("malf_bf16",
             dataclasses.replace(malf.model, **BF16),
             malf.infer, malf.label, None),
            ("turbo_int8_lm4", turbo_lm4,
             dataclasses.replace(kitti_vehicle().infer, scales=(1.0,)),
             LabelCfg(), "fused")]


def with_live_threshold(model, batch, infer_cfg):
    """Random weights: put ``score_thresh`` at the 99th percentile of the
    scale-1 map that candidates are decoded from (``refined``, else
    ``score``) of `batch`, so that candidates reach NMS."""
    import torch

    with torch.inference_mode():
        out = model(batch)
        smap = out.get("refined", out["score"])
    thresh = float(torch.quantile(smap.flatten()[::7].float(), 0.99))
    return dataclasses.replace(infer_cfg, score_thresh=thresh)


def phase_forward():
    import torch

    from densebox_tpu_torch import kitti_vehicle

    cfg = kitti_vehicle().model
    img = np.random.RandomState(1).rand(1, 240, 320, 3).astype(np.float32)
    x = torch.from_numpy(img)
    with torch.inference_mode():
        want = init_model(cfg, "cpu")(x)
        got = init_model(cfg, "cuda")(x.cuda())
        torch.cuda.synchronize()
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}
    scale = {k: float(want[k].abs().max()) for k in want}
    emit({"phase": "forward_f32", "model": "kitti_vehicle w1.0", "input": [1, 240, 320, 3],
          "tf32": False, "max_abs_err": errs, "max_abs_value": scale, "tol": 1e-3})
    if not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"f32 forward on the card disagrees with the CPU: {errs}")
    bcfg = dataclasses.replace(cfg, **BF16)
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 480, 640, 3)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        out = init_model(bcfg, "cuda")(x)
        torch.cuda.synchronize()
    shapes = {k: list(v.shape) for k, v in out.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in out.values())
    emit({"phase": "forward_bf16", "input": [2, 480, 640, 3], "shapes": shapes,
          "finite": finite})
    if not finite:
        raise AssertionError("bf16 forward produced non-finite maps")


def recorded_forward(model, x):
    """``model(x)`` and every int8 conv / requant output it made, in order."""
    import torch

    from densebox_tpu_torch.models import quant as mq

    outs = []

    def recording(fn):
        def wrapped(*args, **kw):
            y = fn(*args, **kw)
            outs.append(y)
            return y
        return wrapped

    with mock.patch.object(mq, "qconv_int8", recording(mq.qconv_int8)), \
            mock.patch.object(mq, "requant_epilogue",
                              recording(mq.requant_epilogue)), \
            torch.inference_mode():
        maps = model(x)
    return maps, outs


def phase_forward_int8():
    import torch

    from densebox_tpu_torch import QuantDenseBox, kitti_vehicle

    cfg = dataclasses.replace(kitti_vehicle().model, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(7).rand(2, 240, 320, 3)
                         .astype(np.float32))
    gpu = init_quant_model(cfg, x.cuda())               # calibrated on the card
    cpu = QuantDenseBox(cfg, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    hybrid = QuantDenseBox(cfg, backend="hybrid", device="cuda").eval()
    hybrid.load_state_dict(gpu.state_dict())
    t0 = time.perf_counter()
    want, want_q = recorded_forward(cpu, x)
    cpu_s = time.perf_counter() - t0
    got, got_q = recorded_forward(gpu, x.cuda())
    hyb, _ = recorded_forward(hybrid, x.cuda())
    torch.cuda.synchronize()
    xc, card_ms = x.cuda(), []
    for _ in range(7):                      # host clock, synchronised
        t0 = time.perf_counter()
        with torch.inference_mode():
            gpu(xc)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)
    codes = [(g.cpu(), w) for g, w in zip(got_q, want_q)
             if w.dtype == torch.int8]
    n_codes = sum(w.numel() for _, w in codes)
    n_diff = sum(int((g != w).sum()) for g, w in codes)
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}
    same = {k: bool(torch.equal(got[k].cpu(), want[k])) for k in want}
    fused_eq_hybrid = {k: bool(torch.equal(got[k], hyb[k])) for k in got}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    emit({"phase": "forward_int8", "model": "kitti_vehicle w1.0 int8",
          "input": list(x.shape), "convs": len(got_q),
          "int8_codes_compared": n_codes, "int8_codes_differing": n_diff,
          "maps_equal": same, "max_abs_err": errs,
          "max_abs_value": {k: float(v.abs().max()) for k, v in want.items()},
          "fused_equals_hybrid": fused_eq_hybrid, "finite": finite,
          "cpu_plain_seconds": cpu_s,
          "card_forward_ms_median_of_7": float(np.median(card_ms))})
    if not finite or n_diff or not all(same.values()):
        raise AssertionError("int8 forward on the card differs from the "
                             "plain versions on the CPU")
    if not all(fused_eq_hybrid.values()):
        raise AssertionError(f"fused and hybrid int8 chains differ on the "
                             f"card: {fused_eq_hybrid}")


def request_images(n, canvas_hw, seed):
    rng = np.random.RandomState(seed)
    hc, wc = canvas_hw
    sizes = [(hc, wc), (hc * 5 // 6, wc * 4 // 5), (hc // 2, wc // 2),
             (hc, wc * 2 // 3)]
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = rng.rand(h, w, 3).astype(np.float32) * 0.3
        y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
        img[y:y + h // 3, x:x + w // 3] += 0.6
        out.append(img)
    return out


def mismatch(res, direct):
    """None if the served result `res` equals the direct detect `direct`
    (the same keys: boxes, scores and, with landmarks, lm_points and
    lm_valid) exactly, else what differs."""
    if set(res) == set(direct) and all(np.array_equal(res[k], direct[k])
                                       for k in direct):
        return None
    out = {"served": len(res["boxes"]), "direct": len(direct["boxes"]),
           "keys": sorted(set(res) ^ set(direct))}
    if len(direct["boxes"]) == len(res["boxes"]):
        out.update({f"max_{k}_diff": float(np.abs(
            res[k].astype(np.float64) - direct[k]).max(initial=0))
            for k in direct if k in res})
    return out


def alone_batch(img, max_batch, canvas_hw):
    """A server's device batch for ``img`` (float, in [0, 1]) alone: the
    image in slot 0 of a ``max_batch`` canvas batch, zeros elsewhere."""
    import torch

    x = np.zeros((max_batch,) + tuple(canvas_hw) + (3,), np.float32)
    x[0, :img.shape[0], :img.shape[1]] = img
    return torch.from_numpy(x)


def slot_detections(out, s):
    """Slot ``s`` of a detections dict as a served result: numpy arrays of
    its valid detections (boxes, scores and, with landmarks, lm_points and
    lm_valid)."""
    v = out["valid"][s].cpu().numpy()
    return {k: t[s].cpu().numpy()[v] for k, t in out.items() if k != "valid"}


def served_detections(model, img, infer_cfg, label_cfg, max_batch,
                      canvas_hw):
    """What a server answers for ``img`` (letterboxed, no downscale) alone
    in its device call: slot 0 of a direct detect of ``alone_batch``."""
    import torch

    from densebox_tpu_torch.infer import detect_batch

    with torch.inference_mode():
        out = detect_batch(model, alone_batch(img, max_batch, canvas_hw)
                           .cuda(), infer_cfg, label_cfg)
    return slot_detections(out, 0)


def init_quant_model(cfg, calib, backend="fused", seed=0, loc_bias=0.0):
    """The int8 model of the float model ``init_model`` makes, calibrated
    on ``calib`` (on its device)."""
    from densebox_tpu_torch.models import QuantDenseBox, quantize_densebox

    sd = quantize_densebox(float_state(cfg, seed, loc_bias), cfg, calib)
    model = QuantDenseBox(cfg, backend=backend, device=calib.device)
    model.load_state_dict(sd)
    return model.eval()


def phase_decode_card_vs_cpu():
    """Everything after the forward on the card and on the CPU, on the
    same maps; identical results, the scale selection's flips counted."""
    import torch

    from densebox_tpu_torch.infer import (detect_from_maps, lm_scale_select,
                                          pyramid_maps)

    name, cfg, infer, label, _ = landmark_cells()[0]
    x = torch.from_numpy(np.random.RandomState(14).rand(2, 240, 320, 3)
                         .astype(np.float32)).cuda()
    model = init_model(cfg, "cuda", loc_bias=1.0)
    infer = with_live_threshold(model, x, infer)
    with torch.inference_mode():
        levels = pyramid_maps(model, x, infer)
        cpu_levels = [({k: v.cpu() for k, v in out.items()}, xy)
                      for out, xy in levels]
        got = detect_from_maps(levels, (240, 320), infer, label)
        t0 = time.perf_counter()
        want = detect_from_maps(cpu_levels, (240, 320), infer, label)
        cpu_s = time.perf_counter() - t0
        xy = [xy for _, xy in levels]
        sel_cpu = lm_scale_select(want["boxes"], None, xy, infer, label)
        sel_card = lm_scale_select(want["boxes"].cuda(), None, xy, infer,
                                   label)
    got = {k: v.cpu() for k, v in got.items()}
    same = {k: bool(torch.equal(got[k], want[k])) for k in want}
    valid = want["valid"]
    emit({"phase": "lm_decode_card_vs_cpu", "model": f"{name} w1.0",
          "input": list(x.shape), "scales": list(infer.scales),
          "detections": int(valid.sum()),
          "lm_valid": int(want["lm_valid"].sum()),
          "equal": same, "max_abs_err": {
              k: float((got[k].double() - want[k].double()).abs()
                       .masked_fill(got[k] == want[k], 0).max())
              for k in want},
          "std_sel_differing": int((sel_cpu != sel_card.cpu())[valid].sum()),
          "std_sel_compared": int(valid.sum()), "cpu_seconds": cpu_s})
    if not valid.any() or not want["lm_valid"].any():
        raise AssertionError("phase 10 decoded no detection or no landmark")
    if not all(same.values()):
        raise AssertionError(f"landmark detect on the card differs from the "
                             f"CPU on the same maps: {same}")


def reset_launches() -> None:
    from densebox_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()


def read_launches() -> dict:
    """Every kernel's launch count since the last reset, by kernel name (the
    labels module counts its two kernels apart)."""
    from densebox_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def phase_serve(name, model_cfg, infer_cfg, label_cfg, quant=None,
                canvas_hw=(480, 640), n_req=24, n_threads=8, loc_bias=0.0):
    """Serve ``n_req`` requests from ``n_threads`` clients with the float
    model, or with ``quant`` ('fused' or 'hybrid') its int8 model calibrated
    on the first canvas batch. Returns the kernels' launch counts."""
    import torch

    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.models.quant import conv_shapes
    from densebox_tpu_torch.ops.kernels import qconv as kq
    from densebox_tpu_torch.serve import DetectServer

    imgs = request_images(n_req, canvas_hw, seed=3)
    canvas = np.zeros((8,) + tuple(canvas_hw) + (3,), np.float32)
    for i in range(8):
        h, w = imgs[i].shape[:2]
        canvas[i, :h, :w] = imgs[i]
    canvas_t = torch.from_numpy(canvas).cuda()
    model = (init_quant_model(model_cfg, canvas_t, quant, loc_bias=loc_bias)
             if quant else init_model(model_cfg, "cuda", loc_bias=loc_bias))
    infer_cfg = with_live_threshold(model, canvas_t, infer_cfg)
    thresh = infer_cfg.score_thresh

    server = DetectServer(model, infer_cfg, label_cfg, canvas_hw=canvas_hw,
                          max_batch=8, batch_window_ms=15.0)
    results, lat = [None] * n_req, [None] * n_req
    try:
        reset_launches()
        t0 = time.perf_counter()

        def client(tid):
            for i in range(tid, n_req, n_threads):
                t = time.perf_counter()
                results[i] = server.submit(imgs[i], timeout=300)
                lat[i] = time.perf_counter() - t

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        launches = read_launches()
        variants = dict(kq.variant_launches)
        stats = dict(server.stats)
    finally:
        server.close()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"{name}: not every request was answered")
    # Each request was served letterboxed (no image is larger than the
    # canvas: no change of coordinates) from one slot of one device call,
    # beside whichever requests shared it. It is held, bit for bit, to a
    # direct detect of its image alone in slot 0 of a zero batch of the
    # server's size; and each of the first 8 images' detect in its slot of
    # `canvas` (beside 7 other images) to the same.
    alone = [served_detections(model, img, infer_cfg, label_cfg, 8,
                               canvas_hw) for img in imgs]
    diffs = {i: d for i, d in enumerate(
        mismatch(res, want) for res, want in zip(results, alone))
        if d is not None}
    with torch.inference_mode():
        canvas_out = detect_batch(model, canvas_t, infer_cfg, label_cfg)
    slot_dependent = [i for i in range(8) if mismatch(
        slot_detections(canvas_out, i), alone[i]) is not None]
    n_out = [len(r["boxes"]) for r in results]
    finite = all(np.isfinite(r[k]).all() for r in results
                 for k in ("boxes", "scores", "lm_points") if k in r)
    calls = stats["device_calls"]
    # one int8 conv per conv of the model, and with the hybrid chain one
    # requant after each, and one int8 neck per call (the float model
    # launches none of them); one window gather per call for a landmark
    # model
    shapes = conv_shapes(model_cfg) if quant else {}
    n_conv = len(shapes)
    # each conv on the variant its widths name: the tensor cores whenever
    # Cin is a multiple of 16 (every conv of the turbo model), through
    # wgmma where Cin is a multiple of 32 and Cout at least 64
    want_variants = {}
    for cout, cin, k, _ in shapes.values():
        v = kq.kernel_variant(cin, cout, k)
        want_variants[v] = want_variants.get(v, 0) + calls
    want = {"nms": calls, "qconv": n_conv * calls,
            "requant": n_conv * calls if quant == "hybrid" else 0,
            "window": calls if model_cfg.num_landmarks else 0,
            "rasterize_boxes": 0, "rasterize_landmarks": 0, "ohem": 0,
            "neck": calls if quant else 0}
    lm = ({"lm_valid_per_request": [int(r["lm_valid"].sum()) for r in results]}
          if model_cfg.num_landmarks else {})
    emit({"phase": name, "requests": stats["requests"],
          "device_calls": calls, "launches": launches,
          "launches_expected": want, "qconv_variants": variants,
          "qconv_variants_expected": want_variants,
          "score_thresh": thresh,
          "nms_out_per_request": n_out, **lm,
          "req_per_s": n_req / wall, "p50_ms": float(np.median(lat)) * 1e3,
          "latency_samples": n_req, "finite": finite,
          "served_equals_alone_in_slot_0": not diffs, "mismatches": diffs,
          "differ_from_canvas_slot": slot_dependent})
    if not finite or sum(n_out) == 0:
        raise AssertionError(f"{name}: detections not finite or none at all")
    if lm and not sum(lm["lm_valid_per_request"]):
        raise AssertionError(f"{name}: every landmark took the centre "
                             f"fallback")
    if diffs or slot_dependent:
        raise AssertionError(f"{name}: served detections differ from a "
                             f"detect of the image alone in slot 0: {diffs}; "
                             f"canvas slots that differ: {slot_dependent}")
    if not calls < stats["requests"] == n_req:
        raise AssertionError(f"{name}: requests were not coalesced: {stats}")
    if calls < 1 or launches != want or variants != want_variants:
        raise AssertionError(f"{name}: kernel launches {launches} "
                             f"{variants} for {calls} device calls, want "
                             f"{want} {want_variants}")
    # (the lm4 model's refine_conv1 has Cin 5 and stays on the CUDA cores)
    if name in ("serve_turbo_int8_fused", "serve_turbo_int8_hybrid") and \
            not all(v.startswith(("mma", "wgmma")) for v in variants):
        raise AssertionError(f"{name}: a conv of the turbo model left the "
                             f"tensor-core variant: {variants}")
    return launches


# --- the train step (phases 13-15) -----------------------------------------


def bits_equal(a, b) -> bool:
    """Equal shapes, dtypes and bits (floats compared as integers)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(as_int), b.view(as_int)
    return bool(torch.equal(a, b))


def train_cfgs():
    """(name, config) of the two train cells: the presets at full width in
    f32, as published (B=32, 240 px patches, K=16)."""
    from densebox_tpu_torch import kitti_vehicle, malf_face

    return [("kitti_vehicle", kitti_vehicle()), ("malf_face", malf_face())]


def phase_step_card_vs_cpu():
    """Phase 13: one train step on the card against the CPU, full width,
    f32, B=4, the same state, batch and draws. A float64 step on the CPU
    gives the rounding noise of float32 gradients themselves (measured on
    this run: up to 1e-3 of a tensor's largest entry between the CPU's own
    f32 and f64), which is why the card-against-CPU bar for gradients is
    5e-3 and not equality."""
    for name, cfg in train_cfgs():
        step_card_vs_cpu("train_step_card_vs_cpu", name, cfg, 4, seed=19,
                         f64=True)


def step_card_vs_cpu(phase, name, cfg, b, seed, f64):
    """One f32 train step of ``cfg`` at batch ``b`` on the card and on the
    CPU (and, with ``f64``, in float64 on the CPU) from the same state,
    batch and draws: GT maps and OHEM masks identical, metrics within 1e-4
    relative, every gradient within 5e-3 of its largest entry; emits the
    line ``phase``."""
    import torch

    from densebox_tpu_torch import DenseBox
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.models import dropout_keep_mask
    from densebox_tpu_torch.ops.kernels.ohem import ohem_select
    from densebox_tpu_torch.ops.labels import rasterize
    from densebox_tpu_torch.train import create_train_state, make_train_step

    grad_tol = 5e-3
    gen = torch.Generator().manual_seed(seed)
    num_lm = cfg.model.num_landmarks
    batch = synthetic_batch(gen, b, cfg.label, cfg.train.max_boxes,
                            num_lm, device="cpu")
    m = cfg.label.map_size
    heads = 3 if num_lm else 2
    draws = {"dropout_keep": dropout_keep_mask(
                 (b, m, m, heads * cfg.model.scaled(cfg.model.head_width)),
                 cfg.model.dropout_rate, gen),
             "ohem_score": torch.rand((b, m * m), generator=gen)}
    if cfg.model.use_refine:
        draws["ohem_refined"] = torch.rand((b, m * m), generator=gen)
    res = {}
    runs = [("cpu", "float32"), ("cuda", "float32")]
    for dev, dtype in runs + ([("cpu", "float64")] if f64 else []):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype, param_dtype=dtype))
        model = DenseBox(c.model, device=dev)
        state = create_train_state(model, c, device=dev)
        step = make_train_step(model, c, device=dev)
        t0 = time.perf_counter()
        _, metrics = step(state, batch, draws=draws)
        res["f64" if dtype == "float64" else dev] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()},
            "seconds": time.perf_counter() - t0}
        del model, state, step
    gts_cpu = rasterize(batch["boxes"], batch["box_valid"], cfg.label,
                        batch.get("landmarks"), batch.get("lm_valid"))
    on_card = {k: v.cuda() for k, v in batch.items()}
    gts_card = rasterize(on_card["boxes"], on_card["box_valid"], cfg.label,
                         on_card.get("landmarks"), on_card.get("lm_valid"))
    gt_same = {k: bits_equal(gts_card[k].cpu(), gts_cpu[k]) for k in gts_cpu}
    sq = torch.rand((b, m * m), generator=gen) ** 2
    pos = (gts_cpu["score"] > 0.5).reshape(b, -1)
    ign = (gts_cpu["ignore"] > 0.5).reshape(b, -1)
    mask_cpu = ohem_select(sq, pos, ign, draws["ohem_score"], 1.0, 0.5, 16)
    mask_card = ohem_select(sq.cuda(), pos.cuda(), ign.cuda(),
                            draws["ohem_score"].cuda(), 1.0, 0.5, 16)
    mask_same = bool(torch.equal(mask_card.cpu(), mask_cpu))
    mc, mg = res["cpu"]["metrics"], res["cuda"]["metrics"]
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc}
    gc, gg = res["cpu"]["grads"], res["cuda"]["grads"]
    grad_rel = {k: float((gg[k] - gc[k]).abs().max() / gc[k].abs().max())
                for k in gc}
    norm = {d: float(torch.sqrt(sum((g.double() ** 2).sum()
                                    for g in res[d]["grads"].values())))
            for d in res}
    worst = max(grad_rel, key=grad_rel.get)
    line = {"phase": phase, "model": f"{name} w1.0 f32", "batch": b,
            "patch": cfg.label.patch_size,
            "precision": "the port's own; torch's flags as it starts",
            "gt_maps_equal": gt_same, "ohem_mask_equal": mask_same,
            "metrics_cpu": mc, "metrics_card": mg, "metrics_rel_err": rel,
            "metrics_tol": 1e-4, "grad_norm": norm,
            "grad_norm_rel_err": abs(norm["cuda"] - norm["cpu"]) / norm["cpu"],
            "grad_max_rel_err": grad_rel[worst], "grad_worst": worst,
            "grad_tol": grad_tol,
            "seconds": {d: res[d]["seconds"] for d in res}}
    if f64:
        g64 = res["f64"]["grads"]
        line["grad_max_rel_err_vs_cpu_f64"] = {
            d: max(float((res[d]["grads"][k] - g64[k]).abs().max()
                         / g64[k].abs().max()) for k in g64)
            for d in ("cpu", "cuda")}
    emit(line)
    if not all(gt_same.values()) or not mask_same:
        raise AssertionError(f"{name}: GT maps or OHEM mask on the card "
                             f"differ from the CPU")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"{name}: train metrics on the card differ "
                             f"from the CPU: {rel}")
    if (grad_rel[worst] > grad_tol
            or abs(norm["cuda"] - norm["cpu"]) > grad_tol * norm["cpu"]):
        raise AssertionError(f"{name}: gradients on the card differ from "
                             f"the CPU: {grad_rel}")


def phase_step_repeats():
    """Phase 13, second part: the full-width step (B=32, f32; malf_face
    through the canvas step) taken twice from the same parameters, momentum
    and generator state gives the same parameters, momentum and update norm
    bit for bit; and what the pinning that makes it so
    (``train/loop.py:repeatable_kernels``) costs, as ms/step with it and
    with it taken out, in turns."""

    import torch

    from densebox_tpu_torch import DenseBox
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.train import (create_train_state, loop,
                                          make_canvas_train_step,
                                          make_train_step)

    for name, cfg in train_cfgs():
        canvas = name == "malf_face"
        data_label = (dataclasses.replace(cfg.label, patch_size=480) if canvas
                      else cfg.label)
        model = DenseBox(cfg.model)
        state = create_train_state(model, cfg)
        step = (make_canvas_train_step if canvas else make_train_step)(model,
                                                                       cfg)
        gen = torch.Generator(device="cuda").manual_seed(19)
        batch = synthetic_batch(gen, cfg.train.batch_size, data_label,
                                cfg.train.max_boxes, cfg.model.num_landmarks)
        step(state, batch)                       # a state with momentum
        start = ({k: v.clone() for k, v in model.state_dict().items()},
                 {k: v.clone() for k, v in state.momentum.items()},
                 state.generator.get_state())
        runs = []
        for _ in range(2):
            state.load(start[0], start[1], 1)
            state.generator.set_state(start[2])
            _, metrics = step(state, batch)
            torch.cuda.synchronize()
            runs.append(({k: v.clone() for k, v in model.state_dict().items()},
                         {k: v.clone() for k, v in state.momentum.items()},
                         metrics["update_norm"].clone(),
                         metrics["loss_total"].clone()))
        differing = sorted(
            {k for a, b in zip(runs[0][:2], runs[1][:2]) for k in a
             if not torch.equal(a[k], b[k])})
        norms = [r[2].item() for r in runs]
        same = not differing and torch.equal(runs[0][2], runs[1][2]) \
            and torch.equal(runs[0][3], runs[1][3])

        def ms_per_step(steps=8):
            step(state, batch)                   # cuDNN settles here
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, batch)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps * 1e3

        ms = {"pinned": [], "unpinned": []}
        for _ in range(2):
            ms["pinned"].append(ms_per_step())
            with mock.patch.object(loop, "repeatable_kernels",
                                   contextlib.nullcontext):
                ms["unpinned"].append(ms_per_step())
        emit({"phase": "train_step_repeats", "model": f"{name} w1.0 f32",
              "batch": cfg.train.batch_size, "canvas": 480 if canvas else None,
              "bit_equal": same, "tensors_differing": differing,
              "update_norms": norms, "ms_per_step_two_readings": ms,
              "pinning_cost_share": min(ms["pinned"]) / min(ms["unpinned"]) - 1})
        if not same:
            raise AssertionError(f"{name}: two runs of the same step differ: "
                                 f"{differing}, update norms {norms}")


def phase_train(name, cfg, steps, canvas):
    """Phases 14 and 15: train ``cfg`` at full width on synthetic batches
    drawn on the card, B = cfg.train.batch_size. With ``canvas`` the batches
    are 480 px canvases and the step samples its patches on the card.
    Returns the kernels' launch counts over the timed steps and ms/step."""
    import torch

    from densebox_tpu_torch import DenseBox
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.train import (create_train_state,
                                          make_canvas_train_step,
                                          make_train_step)

    b, num_lm = cfg.train.batch_size, cfg.model.num_landmarks
    data_label = (dataclasses.replace(cfg.label, patch_size=480) if canvas
                  else cfg.label)
    model = DenseBox(cfg.model)                 # on the card by default
    state = create_train_state(model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = (make_canvas_train_step if canvas else make_train_step)(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(20)

    def one():
        batch = synthetic_batch(gen, b, data_label, cfg.train.max_boxes, num_lm)
        return step(state, batch)[1]

    warm = [one() for _ in range(2)]      # cuDNN picks its algorithms here
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    metrics = [one() for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    metrics = [{k: float(v) for k, v in m.items()} for m in warm + metrics]
    losses = [m["loss_total"] for m in metrics]
    moved = max(float((v - before[k]).abs().max())
                for k, v in model.state_dict().items())
    finite = all(np.isfinite(v) for m in metrics for v in m.values())
    want = {"rasterize_boxes": steps,
            "rasterize_landmarks": steps if num_lm else 0,
            "ohem": steps * (2 if cfg.model.use_refine else 1)}
    got = {k: launches[k] for k in want}
    emit({"phase": f"train_{name}", "model": f"{name} w1.0 f32",
          "batch": b, "patch": cfg.label.patch_size,
          "canvas": 480 if canvas else None, "tf32": False,
          "steps_timed": steps, "steps_warm_up": 2,
          "ms_per_step": wall / steps * 1e3, "steps_per_s": steps / wall,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    emit({"phase": f"train_{name}_check", "losses": losses,
          "update_norms": [m["update_norm"] for m in metrics],
          "n_pos_last": metrics[-1]["n_pos"],
          "n_sampled_last": metrics[-1]["n_sampled"],
          "loss_first5": float(np.mean(losses[:5])),
          "loss_last5": float(np.mean(losses[-5:])), "finite": finite,
          "max_param_change": moved, "launches": got,
          "launches_expected": want})
    if not finite:
        raise AssertionError(f"train_{name}: a loss or update norm is not finite")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"train_{name}: the loss did not decrease")
    if got != want or not moved > 0:
        raise AssertionError(f"train_{name}: kernel launches {got}, want "
                             f"{want}; parameters moved by {moved}")
    return launches, wall / steps * 1e3


def phase_fit():
    """Phase 16: ``fit`` on kitti_vehicle() at full width, B=32, 240 px, on
    the card by default, fed by a step-keyed stream of synthetic batches,
    into a temporary workdir: 8 steps straight against 4 steps, a restart
    into a new model from the checkpoint, and 4 more."""
    import shutil
    import tempfile

    import torch

    from densebox_tpu_torch import DenseBox, kitti_vehicle
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.train import (create_train_state, fit,
                                          load_for_inference, make_manager,
                                          save_checkpoint)

    cfg = kitti_vehicle()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_every=4, ckpt_every=2, ckpt_keep=2))
    b = cfg.train.batch_size

    def batches(step):
        gen = torch.Generator(device="cuda").manual_seed(2200 + step)
        return synthetic_batch(gen, b, cfg.label, cfg.train.max_boxes)

    def run(workdir, steps, **kw):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(cfg, batches, workdir, num_steps=steps,
                  sample_from_canvas=False, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_launches()

    def state_of(res):
        return ({k: v.clone() for k, v in res.state.model.state_dict().items()},
                {k: v.clone() for k, v in res.state.momentum.items()})

    def equal(a, b):
        return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)

    root = tempfile.mkdtemp(prefix="densebox_fit_")
    try:
        work = {n: os.path.join(root, n) for n in ("straight", "resumed",
                                                   "salted")}
        run(work["straight"], 1)                 # cuDNN picks its algorithms
        shutil.rmtree(work["straight"])
        straight, wall, launches = run(work["straight"], 8)
        # the same 8 steps with no workdir, from a state made beforehand:
        # no set-up, no checkpoint and no log inside the clock, one read of
        # the device at the end; and one checkpoint write alone
        t0 = time.perf_counter()
        fresh = create_train_state(DenseBox(cfg.model), cfg)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        _, wall_bare, _ = run(None, 8, init_state=fresh)
        t0 = time.perf_counter()
        save_checkpoint(make_manager(os.path.join(root, "one")),
                        straight.state, cfg)
        save_ms = (time.perf_counter() - t0) * 1e3
        size_mb = os.path.getsize(os.path.join(
            root, "one", "step_00000008.pt")) / 2 ** 20
        run(work["resumed"], 4)
        shutil.copytree(work["resumed"], work["salted"])
        resumed, _, resumed_launches = run(work["resumed"], 8)
        salted, _, _ = run(work["salted"], 8, run_salt=1)
        same = equal(state_of(straight), state_of(resumed))
        metrics_same = all(
            straight.last_metrics[k] == resumed.last_metrics[k]
            for k in ("loss_total", "update_norm", "loss_cls", "loss_loc"))
        salt_differs = not equal(state_of(straight), state_of(salted))
        kept = make_manager(os.path.join(work["straight"], "ckpt")).all_steps()
        files = sorted(os.listdir(os.path.join(work["straight"], "ckpt")))
        # the last checkpoint, loaded for inference, detects as the model
        # that was trained
        got_cfg, sd = load_for_inference(os.path.join(work["resumed"], "ckpt"))
        loaded = DenseBox(got_cfg.model).eval()
        loaded.load_state_dict(sd)
        canvas = batches(99)["image"][:2]
        infer_cfg = with_live_threshold(loaded, canvas, got_cfg.infer)
        with torch.inference_mode():
            want = detect_batch(straight.state.model.eval(), canvas,
                                infer_cfg, got_cfg.label)
            got = detect_batch(loaded, canvas, infer_cfg, got_cfg.label)
        detect_same = {k: bool(torch.equal(got[k], want[k])) for k in want}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want_launches = {"rasterize_boxes": 8, "rasterize_landmarks": 0, "ohem": 8}
    got_launches = {k: launches[k] for k in want_launches}
    emit({"phase": "fit", "model": "kitti_vehicle w1.0 f32", "batch": b,
          "patch": cfg.label.patch_size, "steps": 8,
          "ms_per_step_through_fit": wall / 8 * 1e3,
          "boundaries": {"log_every": 4, "ckpt_every": 2, "ckpt_keep": 2},
          "ms_per_step_through_fit_without_workdir": wall_bare / 8 * 1e3,
          "model_and_state_set_up_ms": setup_ms,
          "checkpoint_write_ms": save_ms, "checkpoint_file_mb": size_mb,
          "card": card_line(),
          "resumed_bit_equal": same, "resumed_metrics_equal": metrics_same,
          "last_metrics": straight.last_metrics,
          "run_salt_1_differs": salt_differs,
          "checkpoints_kept": kept, "files": files,
          "loaded_model_detects_as_trained": detect_same,
          "detections": int(want["valid"].sum()),
          "launches": got_launches, "launches_expected": want_launches,
          "launches_of_the_4_resumed_steps": {
              k: resumed_launches[k] for k in want_launches}})
    if not (same and metrics_same):
        raise AssertionError("fit: the run resumed from a checkpoint differs "
                             "from the uninterrupted one")
    if not salt_differs:
        raise AssertionError("fit: run_salt=1 did not change the draws")
    if kept != [6, 8] or files != ["step_00000006.pt", "step_00000008.pt"]:
        raise AssertionError(f"fit: checkpoints kept {kept}, files {files}")
    if not all(detect_same.values()) or not int(want["valid"].sum()):
        raise AssertionError(f"fit: the loaded checkpoint does not detect as "
                             f"the trained model: {detect_same}")
    if got_launches != want_launches or any(
            not np.isfinite(v) for v in straight.last_metrics.values()):
        raise AssertionError(f"fit: kernel launches {got_launches}, want "
                             f"{want_launches}; metrics {straight.last_metrics}")


# --- the command line (phase 17) ------------------------------------------

KITTI_HW = (375, 1242)          # the image size of the KITTI object set
KITTI_CANVAS = (384, 1248)      # the CLI's default canvas for it
VEHICLES = ("Car", "Van", "Truck")
TORCH_DEFAULTS: dict = {}       # precision flags as torch starts (main())


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG with every row under filter 0 (none), written with
    the standard library alone."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def write_kitti_dir(root: str, n: int, seed: int, num_lm: int = 0) -> int:
    """A KITTI-format directory: ``n`` numpy scenes at KITTI's size with
    1-6 drawn vehicle boxes each (Car, Van, Truck; truncation, occlusion;
    with ``num_lm`` the box corners as keypoints, one in five invisible)
    and 1-2 DontCare regions. Returns the count of vehicle boxes."""
    rng = np.random.RandomState(seed)
    h, w = KITTI_HW
    os.makedirs(os.path.join(root, "image_2"))
    os.makedirs(os.path.join(root, "label_2"))
    shade = (np.arange(h, dtype=np.float32) * (50.0 / h))[:, None, None]
    n_boxes = 0
    for i in range(n):
        img = (rng.rand(h, w, 3) * 60 + shade).astype(np.uint8)
        lines = []
        for _ in range(rng.randint(1, 7)):
            bh = rng.uniform(25, 150)
            bw = bh * rng.uniform(1.2, 2.5)
            x1, y1 = rng.uniform(0, w - bw - 1), rng.uniform(0, h - bh - 1)
            img[int(y1):int(y1 + bh), int(x1):int(x1 + bw)] = \
                rng.randint(120, 256, 3)
            line = (f"{VEHICLES[rng.randint(3)]} {rng.uniform(0, 0.5):.2f} "
                    f"{rng.randint(0, 3)} -1.58 {x1:.2f} {y1:.2f} "
                    f"{x1 + bw:.2f} {y1 + bh:.2f} 1.57 1.73 4.15 1.00 1.75 "
                    "13.22 -1.62")
            if num_lm:
                pts = np.array([[x1, y1], [x1 + bw, y1], [x1 + bw, y1 + bh],
                                [x1, y1 + bh]] * num_lm)[:num_lm]
                pts[rng.rand(num_lm) < 0.2] = -1.0
                line += " " + " ".join(f"{v:.2f}" for v in pts.ravel())
            lines.append(line)
            n_boxes += 1
        for _ in range(rng.randint(1, 3)):
            dx, dy = rng.uniform(0, w - 80), rng.uniform(0, h - 40)
            lines.append(f"DontCare -1 -1 -10 {dx:.2f} {dy:.2f} "
                         f"{dx + 60:.2f} {dy + 30:.2f} -1 -1 -1 -1000 -1000 "
                         "-1000 -10")
        write_png(os.path.join(root, "image_2", f"{i:06d}.png"), img)
        with open(os.path.join(root, "label_2", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return n_boxes


def run_cli(argv, no_cv2=False):
    """``cli.main(argv)`` in this process with its stdout and stderr
    captured (and, with ``no_cv2``, cv2 hidden as on a machine without it).
    Returns (rc, stdout, stderr)."""
    import io

    from densebox_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    hide = (mock.patch.dict(sys.modules, {"cv2": None}) if no_cv2
            else contextlib.nullcontext())
    with hide, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def load_float_model(workdir):
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train import load_for_inference

    cfg, sd = load_for_inference(os.path.join(workdir, "ckpt"))
    model = DenseBox(cfg.model)
    model.load_state_dict(sd)
    return cfg, model.eval()


def quartiles_ms(seconds):
    q1, q2, q3 = np.percentile(np.asarray(seconds) * 1e3, [25, 50, 75])
    return {"median_ms": float(q2), "q1_ms": float(q1), "q3_ms": float(q3)}


def http_call(port, method, path, body=None, length=None, timeout=300):
    """(status, JSON body) of one request to the local server."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if length is None:
            conn.request(method, path, body=body)
        else:                   # a header that announces a body, and no body
            conn.putrequest(method, path)
            conn.putheader("Content-Length", str(length))
            conn.endheaders()
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def served_json(model, rgb, infer_cfg, label_cfg, max_batch,
                canvas_hw=KITTI_CANVAS):
    """What the server answers for ``rgb`` alone in its device call: a
    direct ``detect_batch`` of a ``max_batch`` canvas batch with the image
    in slot 0 and zeros elsewhere, rounded as the front end rounds."""
    import torch

    from densebox_tpu_torch.infer import detect_batch

    with torch.inference_mode():
        out = detect_batch(model, served_batch(rgb, max_batch, canvas_hw)
                           .cuda(), infer_cfg, label_cfg)
    return front_end_json(out)


def served_batch(rgb, max_batch, canvas_hw=KITTI_CANVAS):
    """The server's device batch for the 8-bit ``rgb`` alone: the image in
    slot 0 of a ``max_batch`` canvas batch, zeros elsewhere."""
    return alone_batch(rgb.astype(np.float32) / 255.0, max_batch, canvas_hw)


def front_end_json(dets):
    """Slot 0 of a detections dict as the HTTP front end answers it."""
    out = {k: v.cpu().numpy() for k, v in dets.items()}
    v = out["valid"][0]
    want = {"n": int(v.sum()),
            "boxes": np.round(out["boxes"][0][v], 2).tolist(),
            "scores": np.round(out["scores"][0][v], 4).tolist()}
    return json.loads(json.dumps(want))


def served_on_cpu(model, rgb, infer_cfg, label_cfg, max_batch):
    """The served call of ``rgb`` held to the CPU: the largest difference
    between the card's maps of slot 0 (every pyramid level) and the CPU's
    maps of that image, and the front end's answer from the card's maps
    decoded on the CPU."""
    import copy

    import torch

    from densebox_tpu_torch.infer import detector

    x = served_batch(rgb, max_batch)
    with torch.inference_mode():
        card = detector.pyramid_maps(model, x.cuda(), infer_cfg)
        cpu = detector.pyramid_maps(copy.deepcopy(model).cpu(), x[:1],
                                    infer_cfg)
        slot0 = [({k: v[:1].cpu() for k, v in m.items()}, s) for m, s in card]
        err = max(float((a[k] - b[k]).abs().max())
                  for (a, _), (b, _) in zip(slot0, cpu) for k in a)
        dets = detector.detect_from_maps(slot0, tuple(x.shape[1:3]),
                                         infer_cfg, label_cfg)
    return err, front_end_json(dets)


def phase_cli(bare_ms: float) -> None:
    """Phase 17: the command line on the card, as a user runs it, on a
    KITTI-format directory of PNG files written here."""
    import glob
    import shutil
    import signal
    import socket
    import tempfile

    import torch

    from densebox_tpu_torch import eval as port_eval
    from densebox_tpu_torch import infer as port_infer
    from densebox_tpu_torch.data import pipeline
    from densebox_tpu_torch.data.imageio import imread
    from densebox_tpu_torch.data.kitti import load_dataset
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.models.quant import conv_shapes
    from densebox_tpu_torch.ops.kernels import qconv as kq
    from densebox_tpu_torch.serve import MAX_BODY_BYTES
    from densebox_tpu_torch.train import make_manager
    from densebox_tpu_torch.utils import logging as port_logging

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="densebox_cli_")
    proc = None
    try:
        data, work = os.path.join(root, "kitti"), os.path.join(root, "run")
        t0 = time.perf_counter()
        n_written = write_kitti_dir(data, 64, seed=23)
        write_s = time.perf_counter() - t0
        images = sorted(glob.glob(os.path.join(data, "image_2", "*.png")))
        samples = load_dataset(os.path.join(data, "image_2"),
                               os.path.join(data, "label_2"))

        # 1. train at the CLI's defaults: full-width kitti_vehicle, f32,
        # B=32, 240 px patches from 384 x 1248 canvases
        loaders, logged = [], []

        class Recorded(pipeline.PrefetchLoader):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                loaders.append(self)

        real_log = port_logging.MetricsLogger.log

        def log(self, step, metrics, prefix="train"):
            vals = real_log(self, step, metrics, prefix)
            logged.append((step, vals))
            return vals

        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mock.patch.object(pipeline, "PrefetchLoader", Recorded), \
                mock.patch.object(port_logging.MetricsLogger, "log", log):
            rc, out, _ = run_cli(["train", "--data-dir", data, "--workdir",
                                  work, "--steps", "12", "--ckpt-every", "6",
                                  "--log-every", "6"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_launches()
        loader = loaders[0]
        kept = make_manager(os.path.join(work, "ckpt")).all_steps()
        losses = [v["loss_total"] for _, v in logged]
        window_ms = 1e3 / logged[-1][1]["steps_per_sec"]
        want = {"rasterize_boxes": 12, "rasterize_landmarks": 0, "ohem": 12,
                "nms": 0, "qconv": 0, "requant": 0, "window": 0, "neck": 0}
        emit({"phase": "cli_train", "argv": "train --data-dir D --workdir W "
              "--steps 12 --ckpt-every 6 --log-every 6",
              "model": "kitti_vehicle w1.0 f32 (the CLI's defaults)",
              "batch": 32, "canvas": list(KITTI_CANVAS), "rc": rc,
              "images": len(samples), "vehicle_boxes": n_written,
              "png_write_s": write_s, "logged_losses": losses,
              "checkpoints": kept, "loader_backend": loader.backend,
              "loader_stats": loader.stats, "launches": launches,
              "launches_expected": want, "wall_s_with_set_up": train_s,
              "ms_per_step_steps_7_to_12": window_ms,
              "bare_step_ms_phase_20": bare_ms, "card": card_line(),
              "last_line": out.strip().splitlines()[-1][:200]})
        if rc != 0 or not all(np.isfinite(losses)) or len(losses) != 2:
            raise AssertionError(f"cli train: rc {rc}, logged {losses}")
        if kept != [6, 12] or launches != want:
            raise AssertionError(f"cli train: checkpoints {kept}, launches "
                                 f"{launches}, want {want}")

        # the loader alone, with the image decoder this machine has and with
        # cv2 hidden (the port's PNG decoder): batches/s over 4 batches
        # after the first, and one image's canvas_batch on this thread
        passes = {}
        for decoder in ("as installed", "without cv2"):
            with (mock.patch.dict(sys.modules, {"cv2": None})
                  if decoder == "without cv2" else contextlib.nullcontext()):
                it = iter(pipeline.PrefetchLoader(samples, 32, KITTI_CANVAS,
                                                  16, seed=1))
                next(it)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(4):
                    next(it)
                torch.cuda.synchronize()
                loader_s = time.perf_counter() - t0
                it.close()
                t0 = time.perf_counter()
                pipeline.canvas_batch(samples[:8], KITTI_CANVAS, 16)
                decode_ms = (time.perf_counter() - t0) / 8 * 1e3
            passes[decoder] = {"batches_per_s": 4 / loader_s,
                               "ms_per_batch": loader_s / 4 * 1e3,
                               "canvas_batch_ms_per_image": decode_ms}
        emit({"phase": "cli_loader", "backend": loader.backend, "batch": 32,
              "canvas": list(KITTI_CANVAS), "cv2": cv2_version(),
              "passes": passes,
              "steps_waited_on_loader_in_cli_train": loader.stats["waited"],
              "of_steps": loader.stats["batches"],
              "bare_step_ms_phase_20": bare_ms, "card": card_line()})

        # 2. eval --protocol kitti, a threshold at which candidates reach NMS
        cfg, model = load_float_model(work)
        first = pipeline.canvas_batch(samples[:8], KITTI_CANVAS, 64)
        thresh = with_live_threshold(model, first["image"].cuda(),
                                     cfg.infer).score_thresh
        infer_cfg = dataclasses.replace(cfg.infer, score_thresh=thresh)
        recorded = []
        real_d2n = port_eval.detections_to_numpy

        def d2n(dets, gb, gv):
            recorded.append({k: v.clone() for k, v in dets.items()})
            return real_d2n(dets, gb, gv)

        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.object(port_eval, "detections_to_numpy", d2n):
            rc, out, _ = run_cli(["eval", "--workdir", work, "--data-dir",
                                  data, "--protocol", "kitti",
                                  f"--thresh={thresh!r}"])
        eval_s = time.perf_counter() - t0
        launches = read_launches()
        summary = json.loads(out.strip().splitlines()[-1])
        differs = []
        for c, dets in enumerate(recorded):
            b = pipeline.canvas_batch(samples[8 * c:8 * c + 8], KITTI_CANVAS,
                                      64)
            with torch.inference_mode():
                d = detect_batch(model, b["image"].cuda(), infer_cfg,
                                 cfg.label)
            if not all(torch.equal(d[k], dets[k]) for k in dets):
                differs.append(c)
        want = {"nms": len(recorded), "qconv": 0, "window": 0}
        got = {k: launches[k] for k in want}
        emit({"phase": "cli_eval", "argv": "eval --workdir W --data-dir D "
              "--protocol kitti --thresh T", "rc": rc, "thresh": thresh,
              "summary": summary, "vehicle_boxes_written": n_written,
              "device_calls": len(recorded), "launches": got,
              "launches_expected": want,
              "calls_differing_from_direct_detect": differs,
              "seconds": eval_s})
        if rc != 0 or summary["n_gt"] != n_written or summary["n_images"] \
                != 64 or not summary["n_pred"] or len(recorded) != 8:
            raise AssertionError(f"cli eval: rc {rc}, {summary}")
        if got != want or differs:
            raise AssertionError(f"cli eval: launches {got} (want {want}); "
                                 f"calls differing from a direct detect "
                                 f"{differs}")

        # 3. quantize, then detect 8 files on the int8 workdir, without cv2
        q, kit = os.path.join(root, "q"), os.path.join(root, "kitti_out")
        rc_q, out_q, _ = run_cli(["quantize", "--workdir", work, "--out", q,
                                  "--calib-dir",
                                  os.path.join(data, "image_2")])
        reset_launches()
        t0 = time.perf_counter()
        rc, out, err = run_cli(["detect", "--workdir", q, "--image",
                                *images[:8], "--out",
                                os.path.join(root, "dets"), "--save-kitti",
                                kit, f"--thresh={thresh!r}"], no_cv2=True)
        detect_s = time.perf_counter() - t0
        launches, variants = read_launches(), dict(kq.variant_launches)
        shapes = conv_shapes(cfg.model)
        calls = 8 * len(cfg.infer.scales)         # one forward per level
        want_variants = {}
        for cout, cin, k, _ in shapes.values():
            v = kq.kernel_variant(cin, cout, k)
            want_variants[v] = want_variants.get(v, 0) + calls
        want = {"nms": 8, "qconv": len(shapes) * calls, "requant": 0,
                "window": 0, "neck": calls}
        got = {k: launches[k] for k in want}
        counts = [int(n) for n in re.findall(r": (\d+) detections", out)]
        files = sorted(os.listdir(kit)) if os.path.isdir(kit) else []
        lines = [len(open(os.path.join(kit, f)).read().splitlines())
                 for f in files]
        notes = err.count("no annotated image written")
        emit({"phase": "cli_int8_detect", "argv": "quantize --workdir W --out "
              "Q --calib-dir D; detect --workdir Q --image <8> --save-kitti K",
              "rc_quantize": rc_q, "quantize_said": out_q.strip()[-160:],
              "rc": rc, "detections_per_image": counts,
              "kitti_files": len(files), "kitti_lines": lines,
              "annotated_image_notes": notes, "launches": got,
              "launches_expected": want, "qconv_variants": variants,
              "qconv_variants_expected": want_variants, "seconds": detect_s})
        if rc_q != 0 or rc != 0 or len(counts) != 8 or lines != counts:
            raise AssertionError(f"cli int8 detect: rc {rc_q}/{rc}, "
                                 f"detections {counts}, KITTI lines {lines}")
        if got != want or variants != want_variants or notes != 8:
            raise AssertionError(f"cli int8 detect: launches {got} "
                                 f"{variants}, want {want} {want_variants}; "
                                 f"{notes} notes")

        # 4. serve as a subprocess through the normal entry point
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        serve_log = os.path.join(root, "serve.log")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        with open(serve_log, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "densebox_tpu_torch.cli", "serve",
                 "--workdir", work, "--canvas", *map(str, KITTI_CANVAS),
                 "--port", str(port), f"--thresh={thresh!r}"],
                cwd=REPO, env=env, stdout=logf, stderr=subprocess.STDOUT)
        health = None
        while health is None and time.perf_counter() - t0 < 120:
            if proc.poll() is not None:
                break
            try:
                health = http_call(port, "GET", "/healthz", timeout=5)[1]
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        if health is None:
            raise AssertionError(f"cli serve: no /healthz within 120 s "
                                 f"(rc {proc.poll()}): "
                                 f"{open(serve_log).read()[-2000:]}")
        responses, lat = [], []
        for path in images[:8]:
            with open(path, "rb") as f:
                body = f.read()
            t = time.perf_counter()
            responses.append(http_call(port, "POST", "/detect", body))
            lat.append(time.perf_counter() - t)
        big = http_call(port, "POST", "/detect", length=MAX_BODY_BYTES + 1)
        junk = http_call(port, "POST", "/detect", b"not an image")
        health_after = http_call(port, "GET", "/healthz")[1]
        proc.send_signal(signal.SIGINT)
        t0 = time.perf_counter()
        rc = proc.wait(30)
        stop_s = time.perf_counter() - t0
        proc = None
        # the server process sets no precision flag: the port holds its
        # f32 at the reference's precision, as it does here
        served_cfg = dataclasses.replace(cfg.infer, score_thresh=thresh)
        wants = [served_json(model, imread(p), served_cfg, cfg.label, 8)
                 for p in images[:8]]
        equal = [r == (200, w) for r, w in zip(responses, wants)]
        on_cpu = [served_on_cpu(model, imread(p), served_cfg, cfg.label, 8)
                  for p in images[:2]]
        cpu_err = max(e for e, _ in on_cpu)
        cpu_equal = [r == (200, w) for r, (_, w) in zip(responses, on_cpu)]
        emit({"phase": "cli_serve", "argv": "python3 -m "
              "densebox_tpu_torch.cli serve --workdir W --canvas 384 1248 "
              "--port P --thresh T", "seconds_to_healthz": up_s,
              "health_before": health, "health_after": health_after,
              "statuses": [r[0] for r in responses],
              "detections": [r[1].get("n") for r in responses],
              "responses_equal_direct_detect": equal,
              "oversize": big, "garbage": junk, "rc_after_sigint": rc,
              "seconds_to_stop": stop_s,
              "first_2_maps_max_abs_err_vs_cpu": cpu_err, "maps_tol": 1e-4,
              "first_2_equal_cpu_decode_of_card_maps": cpu_equal})
        emit({"phase": "cli_serve_latency", "requests": len(lat),
              "sequential": True, "canvas": list(KITTI_CANVAS),
              "max_batch": 8, "body": "375x1242 PNG (filter 0), ~1.4 MB",
              **quartiles_ms(lat), "card": card_line()})
        if not all(equal) or not any(r[1].get("n") for r in responses):
            bad = [i for i, e in enumerate(equal) if not e]
            raise AssertionError(
                f"cli serve: responses {bad} differ from a direct detect: "
                f"{[responses[i] for i in bad][:1]} against "
                f"{[wants[i] for i in bad][:1]}")
        if cpu_err > 1e-4 or not all(cpu_equal):
            raise AssertionError(f"cli serve against the CPU: maps {cpu_err}"
                                 f", decode equal {cpu_equal}")
        if big[0] != 413 or junk[0] != 400 or rc != 0 or \
                health_after["requests"] != 8 or health_after["status"] != "ok":
            raise AssertionError(f"cli serve: 413 {big}, 400 {junk}, rc {rc}, "
                                 f"health {health_after}")

        # 5. landmarks: train --landmarks 4, then detect, so that the window
        # kernel is on the CLI's path
        lm_data, lm_work = (os.path.join(root, "kitti_lm"),
                            os.path.join(root, "run_lm"))
        write_kitti_dir(lm_data, 16, seed=24, num_lm=4)
        reset_launches()
        rc_t, _, _ = run_cli(["train", "--data-dir", lm_data, "--workdir",
                              lm_work, "--landmarks", "4", "--width-mult",
                              "0.25", "--steps", "4", "--batch-size", "8",
                              "--ckpt-every", "4", "--log-every", "2"])
        train_launches = read_launches()
        lm_cfg, lm_model = load_float_model(lm_work)
        lm_images = sorted(glob.glob(os.path.join(lm_data, "image_2",
                                                  "*.png")))[:4]
        lm_first = pipeline.canvas_batch(
            load_dataset(os.path.join(lm_data, "image_2"),
                         os.path.join(lm_data, "label_2"))[:4],
            KITTI_CANVAS, 16)
        lm_thresh = with_live_threshold(lm_model, lm_first["image"].cuda(),
                                        lm_cfg.infer).score_thresh
        outs = []
        real_make = port_infer.make_detect_fn

        def make(model_, infer_cfg_, label_cfg_):
            fn = real_make(model_, infer_cfg_, label_cfg_)

            def recording(x):
                o = fn(x)
                outs.append({k: v.clone() for k, v in o.items()})
                return o

            return recording

        reset_launches()
        with mock.patch.object(port_infer, "make_detect_fn", make):
            rc, out, _ = run_cli(["detect", "--workdir", lm_work, "--image",
                                  *lm_images, "--out",
                                  os.path.join(root, "dets_lm"),
                                  f"--thresh={lm_thresh!r}"], no_cv2=True)
        launches = read_launches()
        want_train = {"rasterize_boxes": 4, "rasterize_landmarks": 4,
                      "ohem": 8}
        got_train = {k: train_launches[k] for k in want_train}
        want = {"nms": 4, "window": 4}
        got = {k: launches[k] for k in want}
        finite = bool(outs) and all(
            torch.isfinite(o["lm_points"]).all().item() for o in outs)
        emit({"phase": "cli_landmarks", "argv": "train --landmarks 4 "
              "--width-mult 0.25 --steps 4 --batch-size 8; detect <4>",
              "rc_train": rc_t, "rc_detect": rc,
              "train_launches": got_train,
              "train_launches_expected": want_train,
              "detect_launches": got, "detect_launches_expected": want,
              "device_calls": len(outs), "lm_points_finite": finite,
              "lm_points_shape": (list(outs[0]["lm_points"].shape)
                                  if outs else None),
              "detections": [int(o["valid"].sum()) for o in outs],
              "lm_valid": [int(o["lm_valid"].sum()) for o in outs]})
        if rc_t != 0 or rc != 0 or got_train != want_train or got != want \
                or len(outs) != 4 or not finite:
            raise AssertionError(f"cli landmarks: rc {rc_t}/{rc}, launches "
                                 f"{got_train} {got}, {len(outs)} calls, "
                                 f"finite {finite}")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "cli_seconds", "seconds": time.perf_counter() - t_phase})


# --- multi-device (phase 18) and the 'xla' int8 chain (phase 19) ----------

MULTI_CANVAS = (384, 1248)      # the CLI's KITTI canvas, 4 scales


def _multi_rank(rank: int, world: int, workdir: str, n_model: int) -> None:
    """One of ``world`` processes sharing the card over a gloo group (NCCL
    refuses two ranks on one device): the collectives of ``parallel/`` on
    CUDA tensors, one sharded train step of kitti_vehicle() at B=32 global
    (``n_model`` > 1: data x tensor parallel) and 3 more timed, then a
    ``SpatialDenseBox`` detect over all ranks and its scale-1 maps; saves
    what it saw to ``workdir/rank<r>_<world>.pt``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from densebox_tpu_torch import DenseBox, kitti_vehicle
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.parallel import (SpatialDenseBox, make_mesh,
                                             make_sharded_train_step,
                                             spatial_forward, unshard_state)
    from densebox_tpu_torch.train import create_train_state

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg{world}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=300))
    try:
        out = {"collectives": {}}
        want = float(sum(range(1, world + 1)))
        for dtype in (torch.float32, torch.float64):
            t = torch.full((8,), rank + 1.0, device="cuda", dtype=dtype)
            dist.all_reduce(t)
            out["collectives"][f"all_reduce_{dtype}"] = bool(
                (t == want).all())
        t = torch.full((8,), float(rank), device="cuda")
        dist.broadcast(t, src=world - 1)
        out["collectives"]["broadcast_float32"] = bool(
            (t == world - 1).all())

        cfg = kitti_vehicle()
        data = torch.load(os.path.join(workdir, "data.pt"))
        batch = {k: v.cuda() for k, v in data["batch"].items()}
        model = DenseBox(cfg.model)
        state = create_train_state(model, cfg)
        mesh = make_mesh(n_model=n_model)
        step, place_state, place_batch = make_sharded_train_step(
            model, cfg, mesh, state, tensor_parallel=n_model > 1)
        state = place_state(state)
        local = place_batch(batch)
        reset_launches()
        state, m = step(state, local)
        torch.cuda.synchronize()
        out["launches_step"] = read_launches()
        out["metrics"] = {k: float(v) for k, v in m.items()}
        sd, mom = unshard_state(state, mesh)
        if rank == 0:
            out["sd"] = {k: v.cpu() for k, v in sd.items()}
        out["digest"] = {k: float(v.double().sum()) for k, v in sd.items()}
        out["mesh"] = mesh.shape
        out["rows"] = int(local["image"].shape[0])
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            state, m = step(state, local)
        float(m["loss_total"])
        out["ms_per_step_sharing_the_card"] = (time.perf_counter() - t0) / 3e-3
        del state, model, step, sd, mom
        torch.cuda.empty_cache()

        det = DenseBox(cfg.model)
        det.load_state_dict(float_state(cfg.model, seed=5, loc_bias=1.0))
        det.eval()
        canvas = data["canvas"].cuda()
        infer = dataclasses.replace(cfg.infer, score_thresh=data["thresh"])
        dist.barrier()
        reset_launches()
        t0 = time.perf_counter()
        with torch.inference_mode():
            dets = detect_batch(SpatialDenseBox(det), canvas, infer,
                                cfg.label)
        torch.cuda.synchronize()
        out["detect_ms"] = (time.perf_counter() - t0) * 1e3
        out["launches_detect"] = read_launches()
        out["dets"] = {k: v.cpu() for k, v in dets.items()}
        maps = spatial_forward(det, canvas)     # every rank takes part
        if rank == 0:
            out["maps"] = {k: v.cpu() for k, v in maps.items()}
        torch.save(out, os.path.join(workdir, f"rank{rank}_{world}.pt"))
    finally:
        dist.destroy_process_group()


def phase_multi_device(bare_ms: float):
    """Phase 18 (see the docstring)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from densebox_tpu_torch import DenseBox, kitti_vehicle
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from densebox_tpu_torch.parallel.multihost import run_processes
    from densebox_tpu_torch.train import (create_train_state, fit,
                                          make_train_step)
    from densebox_tpu_torch.train.trainer import data_parallel_ranks

    t_phase = time.perf_counter()
    cfg = kitti_vehicle()
    b = cfg.train.batch_size
    gen = torch.Generator(device="cuda").manual_seed(2400)
    batch = synthetic_batch(gen, b, cfg.label, cfg.train.max_boxes)
    root = tempfile.mkdtemp(prefix="densebox_multi_")
    try:
        # (a) a one-rank NCCL group in this process: the sharded step against
        # the bare step, bit for bit, from the same state, batch and draws
        model = DenseBox(cfg.model)
        state = create_train_state(model, cfg)
        init = ({k: v.clone() for k, v in model.state_dict().items()},
                {k: v.clone() for k, v in state.momentum.items()})
        bare_step = make_train_step(model, cfg)
        state, m_bare = bare_step(state, batch)
        after = ({k: v.clone() for k, v in model.state_dict().items()},
                 {k: v.clone() for k, v in state.momentum.items()})
        state.load(init[0], init[1], 0)
        dist.init_process_group("nccl", init_method=f"file://{root}/pg1",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh()
            step, place_state, place_batch = make_sharded_train_step(
                model, cfg, mesh, state)
            state = place_state(state)
            reset_launches()
            state, m_sh = step(state, place_batch(batch))
            torch.cuda.synchronize()
            launches = read_launches()
            same = (all(torch.equal(v, after[0][k])
                        for k, v in model.state_dict().items())
                    and all(torch.equal(v, after[1][k])
                            for k, v in state.momentum.items()))
            metrics_same = {k: bool(torch.equal(m_bare[k], m_sh[k]))
                            for k in m_bare}

            def ms_per_step(fn):
                fn(state, batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    _, m = fn(state, batch)
                float(m["loss_total"])
                return (time.perf_counter() - t0) / 5e-3

            turns = {"bare": [], "sharded_world1": []}
            for name in ("bare", "sharded_world1", "sharded_world1", "bare"):
                turns[name].append(ms_per_step(
                    bare_step if name == "bare" else step))

            def batches(i):
                g = torch.Generator(device="cuda").manual_seed(2500 + i)
                return synthetic_batch(g, b, cfg.label, cfg.train.max_boxes)

            fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, log_every=4, ckpt_every=2, ckpt_keep=2))
            fresh = create_train_state(DenseBox(cfg.model), cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fit(fcfg, batches, os.path.join(root, "fit"), num_steps=8,
                      sample_from_canvas=False, use_mesh=True,
                      init_state=fresh)
            torch.cuda.synchronize()
            fit_ms = (time.perf_counter() - t0) / 8e-3
            kept = sorted(os.listdir(os.path.join(root, "fit", "ckpt")))
            dp_ranks = data_parallel_ranks(cfg)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
        emit({"phase": "multi_nccl_world1", "backend": backend,
              "model": "kitti_vehicle w1.0 f32", "batch": b,
              "patch": cfg.label.patch_size, "tf32": False,
              "sharded_step_bit_equal_to_bare": same,
              "metrics_bit_equal": metrics_same,
              "launches_sharded_step": launches,
              "ms_per_step_in_turns": turns,
              "bare_ms_phase20": bare_ms,
              "fit_use_mesh_ms_per_step": fit_ms,
              "fit_dp_ranks": dp_ranks,
              "fit_checkpoints": kept,
              "fit_last_metrics": res.last_metrics, "card": card_line()})
        if not same or not all(metrics_same.values()):
            raise AssertionError(f"one-rank NCCL step differs from the bare "
                                 f"step: state {same}, {metrics_same}")
        want_launch = {"rasterize_boxes": 1, "rasterize_landmarks": 0,
                       "ohem": 1}
        if {k: launches[k] for k in want_launch} != want_launch:
            raise AssertionError(f"one-rank NCCL step: launches {launches}, "
                                 f"want {want_launch}")
        if kept != ["step_00000006.pt", "step_00000008.pt"] or not all(
                np.isfinite(v) for v in res.last_metrics.values()):
            raise AssertionError(f"fit(use_mesh): {kept}, {res.last_metrics}")
        want_sd = {k: v.cpu() for k, v in after[0].items()}
        want_m = {k: float(v) for k, v in m_bare.items()}
        del model, state, step, bare_step, after, init, fresh, res
        torch.cuda.empty_cache()

        # the single-device detect the spatial runs are held to
        canvas = np.zeros((2,) + MULTI_CANVAS + (3,), np.float32)
        for i, img in enumerate(request_images(2, MULTI_CANVAS, seed=24)):
            canvas[i, :img.shape[0], :img.shape[1]] = img
        canvas = torch.from_numpy(canvas)
        det = init_model(cfg.model, "cuda", seed=5, loc_bias=1.0)
        infer = with_live_threshold(det, canvas.cuda(), cfg.infer)
        with torch.inference_mode():
            want_det = {k: v.cpu() for k, v in detect_batch(
                det, canvas.cuda(), infer, cfg.label).items()}
            want_maps = {k: v.cpu() for k, v in det(canvas.cuda()).items()}
        del det
        torch.cuda.empty_cache()
        torch.save({"batch": {k: v.cpu() for k, v in batch.items()},
                    "canvas": canvas, "thresh": infer.score_thresh},
                   os.path.join(root, "data.pt"))

        # (b) two and four processes sharing the card over gloo
        for world, n_model in ((2, 1), (4, 2)):
            t0 = time.perf_counter()
            run_processes(_multi_rank, world, (world, root, n_model),
                          timeout=600)
            wall = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(root, f"rank{r}_{world}.pt"))
                     for r in range(world)]
            got_sd = ranks[0]["sd"]
            param_err = max(float((got_sd[k] - want_sd[k]).abs().max())
                            for k in want_sd)
            loss_err = max(abs(r["metrics"]["loss_total"]
                               - want_m["loss_total"]) for r in ranks)
            counts_equal = all(r["metrics"][k] == want_m[k] for r in ranks
                               for k in ("n_pos", "n_sampled"))
            ranks_equal = all(r["digest"] == ranks[0]["digest"]
                              for r in ranks)
            map_err = max(float((ranks[0]["maps"][k] - want_maps[k])
                                .abs().max()) for k in want_maps)
            keep_same = all(torch.equal(r["dets"]["valid"], want_det["valid"])
                            for r in ranks)
            box_err = max(float((r["dets"]["boxes"] - want_det["boxes"])
                                .abs().max()) for r in ranks)
            name = f"dp{world}" if n_model == 1 else "dp2xtp2"
            step_launches = [{k: r["launches_step"][k] for k in
                              ("rasterize_boxes", "rasterize_landmarks",
                               "ohem")} for r in ranks]
            det_launches = [{k: r["launches_detect"][k] for k in
                             ("nms", "window")} for r in ranks]
            emit({"phase": f"multi_{name}_spatial{world}",
                  "processes": world, "backend": "gloo (CUDA tensors), one "
                  "card shared", "mesh": ranks[0]["mesh"],
                  "rows_per_rank": ranks[0]["rows"],
                  "gloo_collectives_on_cuda": ranks[0]["collectives"],
                  "max_param_err_vs_single": param_err,
                  "max_loss_err_vs_single": loss_err,
                  "bars": {"param": 2e-6, "loss": 1e-5, "maps": 2e-5,
                           "boxes": 1e-3},
                  "n_pos_n_sampled_equal": counts_equal,
                  "ranks_bit_equal": ranks_equal,
                  "step_launches_per_rank": step_launches,
                  "ms_per_step_sharing_the_card": [
                      r["ms_per_step_sharing_the_card"] for r in ranks],
                  "spatial_canvas": [2, *MULTI_CANVAS],
                  "spatial_max_map_err_scale1": map_err,
                  "spatial_keep_sets_equal": keep_same,
                  "spatial_max_box_err": box_err,
                  "detections": int(want_det["valid"].sum()),
                  "detect_launches_per_rank": det_launches,
                  "detect_ms_per_rank": [r["detect_ms"] for r in ranks],
                  "wall_s_with_start_up": wall})
            ok_collectives = all(all(r["collectives"].values())
                                 for r in ranks)
            want_launch = {"rasterize_boxes": 1, "rasterize_landmarks": 0,
                           "ohem": 1}
            if not (ok_collectives and param_err < 2e-6 and loss_err < 1e-5
                    and counts_equal and ranks_equal):
                raise AssertionError(f"{name}: the sharded step is not the "
                                     f"single-device step: params "
                                     f"{param_err}, loss {loss_err}")
            if not (map_err < 2e-5 and keep_same and box_err < 1e-3):
                raise AssertionError(f"spatial {world}: maps {map_err}, "
                                     f"keep {keep_same}, boxes {box_err}")
            if any(s != want_launch for s in step_launches) or any(
                    d != {"nms": 1, "window": 0} for d in det_launches):
                raise AssertionError(f"{name}: launches {step_launches} "
                                     f"{det_launches}")

        # (c) the command line under torchrun, one process, NCCL
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        work = os.path.join(root, "cli")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "densebox_tpu_torch.cli",
             "train", "--synthetic", "--workdir", work, "--steps", "3",
             "--ckpt-every", "3", "--log-every", "1"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        kept = sorted(os.listdir(os.path.join(work, "ckpt"))) \
            if os.path.isdir(os.path.join(work, "ckpt")) else []
        emit({"phase": "multi_torchrun_cli", "argv": "torchrun "
              "--standalone --nproc_per_node 1 -m densebox_tpu_torch.cli "
              "train --synthetic --steps 3 --ckpt-every 3 --log-every 1",
              "rc": res.returncode, "checkpoints": kept,
              "stdout_tail": res.stdout[-600:], "wall_s": cli_s})
        if res.returncode != 0 or kept != ["step_00000003.pt"] or \
                "done at step 3" not in res.stdout:
            raise AssertionError(f"torchrun cli train: rc {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "multi_seconds", "seconds": time.perf_counter() - t_phase})


def phase_xla_int8():
    """Phase 19: the turbo_int8 cell (B=8, 480 x 640, one scale) with the
    JAX package's default chain, ``QuantDenseBox(backend='xla')``."""
    import torch

    from densebox_tpu_torch import QuantDenseBox
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.models import quant as mq

    _, turbo, turbo_infer, label = serving_cells()[1]
    canvas = np.zeros((8, 480, 640, 3), np.float32)
    for i, img in enumerate(request_images(8, (480, 640), seed=25)):
        canvas[i, :img.shape[0], :img.shape[1]] = img
    x = torch.from_numpy(canvas).cuda()
    fused = init_quant_model(turbo, x)                 # calibrated on the card
    xla = QuantDenseBox(turbo, backend="xla", device="cuda").eval()
    xla.load_state_dict(fused.state_dict())
    cpu = QuantDenseBox(turbo, backend="xla", device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in fused.state_dict().items()})
    infer = with_live_threshold(xla, x, turbo_infer)

    def recorded(model, images):
        seen = []
        real = mq.qconv_int8

        def recording(x_q, *args, out="int8", **kw):
            acc = real(x_q, *args, out=out, **kw)
            seen.append((x_q, acc, out))
            return acc

        with mock.patch.object(mq, "qconv_int8", recording), \
                torch.inference_mode():
            maps = model(images)
        return maps, seen

    got, got_q = recorded(xla, x)
    want, want_q = recorded(cpu, x.cpu())
    n_codes = sum(w[0].numel() for w in want_q)
    codes_diff = sum(int((g[0].cpu() != w[0]).sum())
                     for g, w in zip(got_q, want_q))
    acc_diff = sum(int((g[1].cpu() != w[1]).sum())
                   for g, w in zip(got_q, want_q))
    modes = [g[2] for g in got_q]
    same = {k: bool(torch.equal(got[k].cpu(), want[k])) for k in want}
    reset_launches()
    with torch.inference_mode():
        dets = detect_batch(xla, x, infer, label)
    torch.cuda.synchronize()
    launches = read_launches()

    def call_ms(model):
        with torch.inference_mode():
            detect_batch(model, x, infer, label)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            detect_batch(model, x, infer, label)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {"fused": [], "xla": []}
    for name in ("fused", "xla", "xla", "fused") * 3:
        model = fused if name == "fused" else xla
        call_ms(model)
        times[name] += [call_ms(model) for _ in range(10)]
    emit({"phase": "xla_int8", "model": "turbo (s2d4, depth 3, w0.25) int8",
          "backend": "xla", "batch": 8, "canvas": [480, 640], "scales": [1.0],
          "convs": len(got_q), "modes": sorted(set(modes)),
          "int8_codes_compared": n_codes, "int8_codes_differing": codes_diff,
          "int32_accumulators_differing": acc_diff, "maps_equal": same,
          "launches_per_call": launches,
          "detections": int(dets["valid"].sum()),
          "device_call_ms": {k: quartiles_ms(np.asarray(v) / 1e3)
                             for k, v in times.items()},
          "timing": "host clock around one synchronised detect_batch of "
                    "the canvas batch; 30 calls a backend in turns "
                    "(fused, xla, xla, fused) x 3",
          "card": card_line()})
    if codes_diff or acc_diff or not all(same.values()):
        raise AssertionError(f"xla int8 on the card differs from the CPU: "
                             f"{codes_diff} codes, {acc_diff} accumulators, "
                             f"{same}")
    if modes != ["int32"] * 14 or launches["qconv"] != 14 or \
            launches["requant"] != 0 or launches["nms"] != 1:
        raise AssertionError(f"xla int8: modes {modes}, launches {launches}")


# a process that loads an artifact with the JAX package and jax blocked and
# every model forward and detect_batch raising (phase 20)
FRESH_LOAD = """
import json, sys
from unittest import mock
sys.modules["densebox_tpu"] = None
sys.modules["jax"] = None
import numpy as np
import torch
from densebox_tpu_torch import export, infer
from densebox_tpu_torch.infer import detector
from densebox_tpu_torch.models import DenseBox, QuantDenseBox
from densebox_tpu_torch.ops.kernels import neck, nms, qconv


def boom(*args, **kwargs):
    raise AssertionError("model code ran")


for owner, name in ((DenseBox, "forward"), (QuantDenseBox, "forward"),
                    (QuantDenseBox, "_forward_xla"),
                    (QuantDenseBox, "_forward_fused"),
                    (detector, "detect_batch"),
                    (detector, "detect_from_maps"), (infer, "detect_batch"),
                    (export, "detect_batch")):
    mock.patch.object(owner, name, boom).start()
call, meta = export.load_exported(sys.argv[1])
out = call(torch.from_numpy(np.load(sys.argv[2])).cuda())
torch.cuda.synchronize()
np.savez(sys.argv[3], **{k: v.cpu().numpy() for k, v in out.items()})
print(json.dumps({"launches": {"nms": nms.launches, "qconv": qconv.launches,
                               "neck": neck.launches},
                  "jax_modules": sorted(m for m in sys.modules if m.split(
                      ".")[0] in ("jax", "jaxlib", "flax") and sys.modules[m])}))
"""


def export_cells():
    """The cells of phase 20 as (name, model config, infer and label
    configs, int8 chain or None, loc bias): turbo_int8 (the int8 serve
    cell), paper and malf_bf16 (the bf16 serve cells)."""
    (_, paper, p_infer, p_label), (_, turbo, t_infer, t_label) = \
        serving_cells()
    malf = landmark_cells()[0]
    return [("turbo_int8", turbo, t_infer, t_label, "fused", 0.0),
            ("paper", paper, p_infer, p_label, None, 0.0),
            (malf[0], *malf[1:4], None, 1.0)]


def phase_export():
    """Phase 20: the detect pipeline exported (``export.py``) at full width,
    reloaded and run against the live path; a load in a fresh process with
    no model code; ``cli export`` then ``cli serve --artifact``."""
    import shutil
    import signal
    import socket
    import tempfile

    import torch

    from densebox_tpu_torch.export import (DetectProgram, artifact_meta,
                                           export_detect_program,
                                           load_exported, save_exported)
    from densebox_tpu_torch.infer import detect_batch, detector, resize
    from densebox_tpu_torch.ops import upsample
    from densebox_tpu_torch.ops.kernels import qconv as kq

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="densebox_export_")
    proc = None
    try:
        canvas = np.zeros((8, 480, 640, 3), np.float32)
        images = request_images(8, (480, 640), seed=26)
        for i, img in enumerate(images):
            canvas[i, :img.shape[0], :img.shape[1]] = img
        x = torch.from_numpy(canvas).cuda()
        turbo_out = turbo_path = None
        for name, cfg, infer, label, quant, loc_bias in export_cells():
            model = (init_quant_model(cfg, x, quant) if quant
                     else init_model(cfg, "cuda", loc_bias=loc_bias))
            infer = with_live_threshold(model, x, infer)

            def live():
                with torch.inference_mode():
                    return detect_batch(model, x, infer, label)

            want = live()
            # a trace in a process whose constant caches are cold keeps
            # none of the fake tensors it makes: the live path is unchanged
            for cache in (detector._table, resize._weights,
                          upsample._interp_matrix):
                cache.cache_clear()
            if quant:
                model.refresh_constants()
            with torch.no_grad():
                torch.export.export(DetectProgram(model, infer, label), (x,),
                                    strict=False)
            kept = len(model._consts) if quant else None
            after = live()
            cold_ok = all(torch.equal(after[k], want[k]) for k in want)

            t0 = time.perf_counter()
            ep = export_detect_program(model, infer, label, 8, (480, 640))
            export_s = time.perf_counter() - t0
            path = os.path.join(root, f"{name}.pt2")
            t0 = time.perf_counter()
            save_exported(path, ep, artifact_meta(model, infer, 8,
                                                  (480, 640)))
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            call, meta = load_exported(path)
            load_s = time.perf_counter() - t0

            reset_launches()
            kq.variant_launches.clear()
            got = call(x)
            torch.cuda.synchronize()
            art_launches, art_variants = read_launches(), dict(
                kq.variant_launches)
            reset_launches()
            kq.variant_launches.clear()
            live()
            torch.cuda.synchronize()
            live_launches, live_variants = read_launches(), dict(
                kq.variant_launches)
            equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
            # each slot of the artifact's batch as a server answers it: a
            # live detect of its image alone in slot 0 of a zero batch
            not_as_alone = [i for i, img in enumerate(images) if mismatch(
                slot_detections(got, i), served_detections(
                    model, img, infer, label, 8, (480, 640))) is not None]
            times = {"live": [], "artifact": []}
            for which in ("live", "artifact", "artifact", "live") * 3:
                times[which] += event_seconds(
                    live if which == "live" else (lambda: call(x)), 5)
            emit({"phase": f"export_{name}", "batch": 8,
                  "canvas": [480, 640], "meta": meta,
                  "export_s": export_s, "save_s": save_s, "load_s": load_s,
                  "artifact_mb": os.path.getsize(path) / 1e6,
                  "graph_nodes": len(ep.graph.nodes),
                  "outputs_equal_live": equal,
                  "slots_not_as_alone_in_slot_0": not_as_alone,
                  "detections": int(want["valid"].sum()),
                  "launches_artifact": art_launches,
                  "launches_live": live_launches,
                  "qconv_variants_artifact": art_variants,
                  "cold_trace_consts_kept": kept,
                  "live_after_cold_trace_equal": cold_ok,
                  "device_call_ms": {k: quartiles_ms(v)
                                     for k, v in times.items()},
                  "timing": "CUDA events around one call of the canvas "
                            "batch; 30 calls each, in turns (live, "
                            "artifact, artifact, live) x 3, 5 a turn",
                  "card": card_line()})
            want_launches = {"nms": 1, "qconv": 14 if quant else 0,
                             "requant": 0,
                             "window": 1 if cfg.num_landmarks else 0,
                             "rasterize_boxes": 0, "rasterize_landmarks": 0,
                             "ohem": 0, "neck": 1 if quant else 0}
            if not all(equal.values()) or not want["valid"].any() or \
                    not_as_alone:
                raise AssertionError(f"export {name}: the artifact differs "
                                     f"from the live detect: {equal}, or "
                                     f"its slots {not_as_alone} from a "
                                     f"detect of their image alone")
            if art_launches != want_launches or live_launches != \
                    want_launches or art_variants != live_variants or (
                    quant and not all(v.startswith(("mma", "wgmma"))
                                      for v in art_variants)):
                raise AssertionError(
                    f"export {name}: launches {art_launches} {art_variants}, "
                    f"live {live_launches} {live_variants}")
            if not cold_ok or kept:
                raise AssertionError(f"export {name}: a cold trace changed "
                                     f"the live path ({kept} kept)")
            if name == "turbo_int8":
                turbo_out, turbo_path = got, path
            del model, ep, call

        # the turbo_int8 artifact in a fresh process: no JAX, no model code
        xpath, opath = (os.path.join(root, "x.npy"),
                        os.path.join(root, "fresh.npz"))
        np.save(xpath, canvas)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", FRESH_LOAD, turbo_path,
                              xpath, opath], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        fresh_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"fresh-process load failed: "
                                 f"{res.stdout[-1000:]}{res.stderr[-2000:]}")
        said = json.loads(res.stdout.strip().splitlines()[-1])
        fresh = dict(np.load(opath))
        fresh_equal = {k: bool(np.array_equal(fresh[k], v.cpu().numpy()))
                       for k, v in turbo_out.items()}
        emit({"phase": "export_fresh_process", "artifact": "turbo_int8",
              "blocked": ["densebox_tpu", "jax", "DenseBox.forward",
                          "QuantDenseBox.forward", "detect_batch"],
              "seconds": fresh_s, **said, "outputs_equal_parent": fresh_equal})
        if not all(fresh_equal.values()) or said["jax_modules"] or \
                said["launches"] != {"nms": 1, "qconv": 14, "neck": 1}:
            raise AssertionError(f"fresh-process load: {said} {fresh_equal}")

        # cli export, then cli serve --artifact as a subprocess
        work, art = os.path.join(root, "run"), os.path.join(root, "cli.pt2")
        rc_t, _, err_t = run_cli(["train", "--synthetic", "--workdir", work,
                                  "--steps", "1", "--batch-size", "4",
                                  "--ckpt-every", "1"])
        if rc_t != 0:
            raise AssertionError(f"cli train: rc {rc_t}: {err_t[-2000:]}")
        cfg, model = load_float_model(work)
        thresh = with_live_threshold(model, x, cfg.infer).score_thresh
        t0 = time.perf_counter()
        rc_x, out_x, err_x = run_cli(["export", "--workdir", work, "--out",
                                      art, f"--thresh={thresh!r}"])
        cli_export_s = time.perf_counter() - t0
        if rc_x != 0 or "verify: reload + call ok" not in out_x:
            raise AssertionError(f"cli export: rc {rc_x}: {out_x[-1000:]} "
                                 f"{err_x[-2000:]}")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        serve_log = os.path.join(root, "serve.log")
        t0 = time.perf_counter()
        with open(serve_log, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "densebox_tpu_torch.cli", "serve",
                 "--artifact", art, "--port", str(port)], cwd=REPO, env=env,
                stdout=logf, stderr=subprocess.STDOUT)
        health = None
        while health is None and time.perf_counter() - t0 < 120:
            if proc.poll() is not None:
                break
            try:
                health = http_call(port, "GET", "/healthz", timeout=5)[1]
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        if health is None:
            raise AssertionError(f"cli serve --artifact: no /healthz within "
                                 f"120 s (rc {proc.poll()}): "
                                 f"{open(serve_log).read()[-2000:]}")
        rgbs = [np.round(img * 255).astype(np.uint8)
                for img in request_images(4, (480, 640), seed=27)]
        responses = []
        for i, rgb in enumerate(rgbs):
            png = os.path.join(root, f"{i}.png")
            write_png(png, rgb)
            with open(png, "rb") as f:
                responses.append(http_call(port, "POST", "/detect", f.read()))
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(30)
        proc = None
        served_cfg = dataclasses.replace(cfg.infer, score_thresh=thresh)
        wants = [served_json(model, rgb, served_cfg, cfg.label, 8,
                             (480, 640)) for rgb in rgbs]
        equal = [r == (200, w) for r, w in zip(responses, wants)]
        emit({"phase": "export_cli", "argv": "cli export --workdir W --out A "
              "--thresh T; python3 -m densebox_tpu_torch.cli serve "
              "--artifact A --port P", "export_s": cli_export_s,
              "export_said": out_x.strip().splitlines(),
              "artifact_mb": os.path.getsize(art) / 1e6,
              "seconds_to_healthz": up_s, "health": health,
              "detections": [r[1].get("n") for r in responses],
              "responses_equal_direct_detect": equal, "rc_after_sigint": rc})
        if not all(equal) or not any(r[1].get("n") for r in responses) or \
                rc != 0 or health.get("artifact") != art:
            raise AssertionError(f"cli serve --artifact: equal {equal}, rc "
                                 f"{rc}, health {health}")
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(10)
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "export_seconds", "seconds": time.perf_counter() - t_phase})


# --- the reference's precision (phase 21), certification (phase 22) ------

@contextlib.contextmanager
def recording(calls):
    """Within it every ``detect_batch`` appends to ``calls`` its input batch,
    the model's input at each level (the resized batch), the levels' maps
    and its detections, each on the CPU."""
    from densebox_tpu_torch.infer import detector

    real_maps, real_decode = detector.pyramid_maps, detector.detect_from_maps

    def maps(model, images, infer_cfg):
        inputs = []

        def forward(x):
            inputs.append(x.cpu())
            return model(x)

        levels = real_maps(forward, images, infer_cfg)
        calls.append({"images": images.cpu(), "inputs": inputs, "levels": [
            ({k: v.cpu() for k, v in m.items()}, sc) for m, sc in levels]})
        return levels

    def decode(levels, image_hw, infer_cfg, label_cfg):
        out = real_decode(levels, image_hw, infer_cfg, label_cfg)
        calls[-1]["dets"] = {k: v.cpu() for k, v in out.items()}
        return out

    with mock.patch.object(detector, "pyramid_maps", maps), \
            mock.patch.object(detector, "detect_from_maps", decode):
        yield calls


def maps_error(a_levels, b_levels) -> float:
    """The largest difference between two pyramids' maps."""
    return max(float((a[k] - b[k]).abs().max())
               for (a, _), (b, _) in zip(a_levels, b_levels) for k in a)


def decode_on_cpu_equal(call, infer_cfg, label_cfg) -> bool:
    """Whether the card's recorded maps, decoded on the CPU, give the card's
    detections bit for bit."""
    from densebox_tpu_torch.infer import detector

    dets = detector.detect_from_maps(call["levels"],
                                     tuple(call["images"].shape[1:3]),
                                     infer_cfg, label_cfg)
    return all(bits_equal(dets[k], call["dets"][k]) for k in dets)


def recorded_int8(codes):
    """Patches of the int8 chain's two kernels that append each output (on
    the CPU) to ``codes``."""
    from densebox_tpu_torch.models import quant as mq

    def wrap(fn):
        def wrapped(*args, **kw):
            y = fn(*args, **kw)
            codes.append(y.cpu())
            return y
        return wrapped

    return [mock.patch.object(mq, "qconv_int8", wrap(mq.qconv_int8)),
            mock.patch.object(mq, "requant_epilogue",
                              wrap(mq.requant_epilogue))]


def codes_compared(a, b):
    """(elements compared, elements that differ) of two lists of kernel
    outputs, which must match in number and shape."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError(f"int8 chains differ in their launches: "
                             f"{len(a)} against {len(b)}")
    return (sum(x.numel() for x in a),
            sum(int((x != y).sum()) for x, y in zip(a, b)))


def int8_card_vs_cpu(qcard, qcpu, calls, infer_cfg, label_cfg):
    """The int8 chain on the card against the CPU on the same inputs: each
    recorded call's level inputs (the card's resized batches) through
    ``qcpu`` on the CPU, every int8 kernel output and map against the
    card's (``calls[i]["codes"]`` where given, else ``detect_batch`` of
    ``qcard`` on the card, recorded here). Returns (codes compared, codes
    differing, maps equal, level-input elements where the CPU's own resize
    differs from the card's)."""
    import torch

    from densebox_tpu_torch.infer import detect_batch, resize_linear

    n = bad = resized = 0
    maps_equal = True
    for call in calls:
        if "codes" not in call:
            codes, rec = [], []
            with contextlib.ExitStack() as stack:
                for p in recorded_int8(codes):
                    stack.enter_context(p)
                stack.enter_context(recording(rec))
                stack.enter_context(torch.inference_mode())
                detect_batch(qcard, call["images"].cuda(), infer_cfg,
                             label_cfg)
            call = dict(rec[0], codes=codes)
        cpu_codes = []
        with contextlib.ExitStack() as stack:
            for p in recorded_int8(cpu_codes):
                stack.enter_context(p)
            stack.enter_context(torch.inference_mode())
            for x, (card_maps, _) in zip(call["inputs"], call["levels"]):
                maps = qcpu(x)
                maps_equal &= all(bits_equal(maps[k], card_maps[k])
                                  for k in maps)
                if x.shape != call["images"].shape:
                    own = resize_linear(call["images"], tuple(x.shape[1:3]))
                    resized += int((own != x).sum())
        total, differ = codes_compared(call["codes"], cpu_codes)
        n, bad = n + total, bad + differ
    return n, bad, maps_equal, resized


def upsample_vs_cpu(x):
    """The x2 upsample of the bf16 NHWC ``x`` (on the card) against the
    CPU's: as two bf16 ``torch.bmm`` (cuBLAS's bf16 GEMM) with its reduced
    bf16 reduction as torch starts and held off, and as the port takes it
    (``interp_bmm``: float32 products, rounded once): elements that differ
    and the largest difference, each."""
    import torch

    from densebox_tpu_torch.device import reference_precision
    from densebox_tpu_torch.ops.upsample import (_interp_matrix,
                                                 upsample2x_align_corners)

    def bf16_bmm(t):
        b, h, w, c = t.shape
        aw = _interp_matrix(w, 2 * w, t.device, t.dtype)
        ah = _interp_matrix(h, 2 * h, t.device, t.dtype)
        y = torch.bmm(aw.expand(b * h, 2 * w, w), t.reshape(b * h, w, c))
        return torch.bmm(ah.expand(b, 2 * h, h), y.reshape(b, h, 2 * w * c))

    def compare(got, want):
        diff = (got.cpu().float() - want.reshape(got.shape).float()).abs()
        return {"differ": int((diff > 0).sum()),
                "max_abs_diff": float(diff.max())}

    want = upsample2x_align_corners(x.cpu())
    out = {"shape": list(x.shape), "elements": want.numel()}
    for mode in ("as_torch_starts", "held_off"):
        with reference_precision("bfloat16", int8_chain=mode == "held_off"):
            out[f"bf16_bmm_reduction_{mode}"] = compare(bf16_bmm(x), want)
    out["port"] = compare(upsample2x_align_corners(x), want)
    return out


def phase_precision(bare_ms: float) -> None:
    """Phase 21: the port's precision under torch's own flags (see the
    module docstring)."""
    import copy
    import shutil
    import tempfile

    import torch

    from densebox_tpu_torch import cli, device as port_device, kitti_vehicle
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.models import (DenseBox, QuantDenseBox,
                                           quantize_densebox)
    from densebox_tpu_torch.models import densebox as dm
    from densebox_tpu_torch.models import quant as mq
    from densebox_tpu_torch.train import (create_train_state, make_manager,
                                          make_train_step, save_checkpoint)

    t_phase = time.perf_counter()
    flags = port_device.precision_flags()
    emit({"phase": "precision_flags_at_start", "flags": flags,
          "torch_defaults": TORCH_DEFAULTS})
    if flags != TORCH_DEFAULTS:
        raise AssertionError(f"precision flags {flags} at phase 21, not "
                             f"torch's {TORCH_DEFAULTS}")
    cfg = kitti_vehicle()                       # full width, f32
    root = tempfile.mkdtemp(prefix="densebox_precision_")
    try:
        # (a) detect_batch and cli detect of an f32 model, card against CPU
        state = create_train_state(DenseBox(cfg.model, device="cuda"), cfg,
                                   device="cuda")
        card = state.model.eval()
        cpu = copy.deepcopy(card).cpu()
        x = np.zeros((2,) + KITTI_CANVAS + (3,), np.float32)
        rgbs = [np.round(img * 255).astype(np.uint8)
                for img in request_images(2, KITTI_HW, seed=27)]
        for i, rgb in enumerate(rgbs):
            x[i, :rgb.shape[0], :rgb.shape[1]] = rgb / np.float32(255.0)
        x = torch.from_numpy(x)
        infer = with_live_threshold(card, x.cuda(), cfg.infer)
        on_card, on_cpu = [], []
        with torch.inference_mode():
            with recording(on_card):
                detect_batch(card, x.cuda(), infer, cfg.label)
            with recording(on_cpu):
                detect_batch(cpu, x, infer, cfg.label)
        err = maps_error(on_card[0]["levels"], on_cpu[0]["levels"])
        decode_equal = decode_on_cpu_equal(on_card[0], infer, cfg.label)
        same = all(bits_equal(on_card[0]["dets"][k], on_cpu[0]["dets"][k])
                   for k in on_cpu[0]["dets"])
        emit({"phase": "precision_detect_f32", "model": "kitti_vehicle w1.0 "
              "f32", "batch": 2, "canvas": list(KITTI_CANVAS),
              "scales": list(infer.scales), "maps_max_abs_err": err,
              "maps_tol": 1e-4, "cpu_decode_of_card_maps_equal": decode_equal,
              "detections": int(on_card[0]["dets"]["valid"].sum()),
              "card_detections_equal_cpu_detect": same})
        if err > 1e-4 or not decode_equal:
            raise AssertionError(f"f32 detect_batch against the CPU: maps "
                                 f"{err}, decode equal {decode_equal}")

        work = os.path.join(root, "w")
        save_checkpoint(make_manager(os.path.join(work, "ckpt"), 1), state,
                        cfg)
        paths = []
        for i, rgb in enumerate(rgbs):
            paths.append(os.path.join(root, f"{i}.png"))
            write_png(paths[-1], rgb)
        argv = ["detect", "--workdir", work, "--image", *paths,
                f"--thresh={infer.score_thresh!r}"]
        runs = {}
        for dev in ("cuda", "cpu"):
            calls = []
            with recording(calls):
                rc, out, _ = run_cli(argv + ["--out", os.path.join(
                    root, f"dets_{dev}")] + (["--device", "cpu"]
                                             if dev == "cpu" else []))
            if rc != 0 or len(calls) != len(paths):
                raise AssertionError(f"cli detect on {dev}: rc {rc}, "
                                     f"{len(calls)} calls")
            runs[dev] = (calls, out)
        errs = [maps_error(a["levels"], b["levels"])
                for a, b in zip(runs["cuda"][0], runs["cpu"][0])]
        decodes = [decode_on_cpu_equal(c, infer, cfg.label)
                   for c in runs["cuda"][0]]
        emit({"phase": "precision_cli_detect_f32", "argv": "detect "
              "--workdir W --image <2 PNG, 375 x 1242> --thresh T [--device "
              "cpu]", "maps_max_abs_err": errs, "maps_tol": 1e-4,
              "cpu_decode_of_card_maps_equal": decodes,
              "printed_equal": runs["cuda"][1] == runs["cpu"][1],
              "printed": runs["cuda"][1].strip().splitlines()[:4]})
        if max(errs) > 1e-4 or not all(decodes):
            raise AssertionError(f"cli detect f32 against the CPU: maps "
                                 f"{errs}, decode equal {decodes}")

        # (b) cli detect --quantize: the int8 chains on the card against
        # the CPU on the int8 state the CLI calibrated on the card
        made, calls, codes = [], [], []
        real_quantize = cli._quantize

        def quantize(*args):
            made.append(real_quantize(*args))
            return made[-1]

        with contextlib.ExitStack() as stack:
            for p in recorded_int8(codes):
                stack.enter_context(p)
            stack.enter_context(recording(calls))
            stack.enter_context(mock.patch.object(cli, "_quantize", quantize))
            rc, out, _ = run_cli(argv + ["--quantize", "--out", os.path.join(
                root, "dets_int8")])
        if rc != 0 or len(made) != 1 or len(calls) != len(paths):
            raise AssertionError(f"cli detect --quantize: rc {rc}")
        per_call = len(codes) // len(calls)
        for i, call in enumerate(calls):
            call["codes"] = codes[i * per_call:(i + 1) * per_call]
        state_dict = {k: v.cpu() for k, v in made[0].state_dict().items()}
        chains = {}
        for backend in ("fused", "xla"):
            models = []
            for dev in ("cuda", "cpu"):
                q = QuantDenseBox(cfg.model, backend=backend, device=dev)
                q.load_state_dict(state_dict)
                models.append(q.eval())
            given = calls if backend == "fused" else [
                {k: v for k, v in c.items() if k != "codes"} for c in calls]
            n, bad, maps_eq, resized = int8_card_vs_cpu(
                *models, given, infer, cfg.label)
            chains[backend] = {"codes_compared": n, "codes_differing": bad,
                               "maps_equal": maps_eq,
                               "level_inputs_cpu_resize_differs": resized}
        calib_cpu = quantize_densebox(
            cpu.state_dict(), cfg.model,
            cli._load_calib_images(paths, "cpu"))
        calib_same = all(bits_equal(calib_cpu[k], state_dict[k])
                         for k in calib_cpu if k.endswith("in_scale"))
        decodes = [decode_on_cpu_equal(c, infer, cfg.label) for c in calls]
        emit({"phase": "precision_cli_detect_int8", "argv": "detect "
              "--workdir W --image <2 PNG> --quantize --thresh T",
              "chains": chains, "launches_per_call": per_call,
              "cpu_decode_of_card_maps_equal": decodes,
              "calibration_on_cpu_equal_card": calib_same})
        if any(c["codes_differing"] or not c["maps_equal"]
               or not c["codes_compared"] for c in chains.values()) \
                or not all(decodes):
            raise AssertionError(f"int8 chains against the CPU: {chains}, "
                                 f"decode equal {decodes}")
        del made, calls, codes

        # (c) the f32 train step at B=32, card against CPU
        step_card_vs_cpu("precision_train_step", "kitti_vehicle", cfg, 32,
                         seed=27, f64=False)

        # (d) the cost: the port's precision against TF32 forced on
        def tf32_forced():
            return mock.patch.dict(port_device.REFERENCE, cudnn_tf32=True,
                                   matmul_tf32=True)

        with tf32_forced(), port_device.reference_precision("float32"):
            forced = port_device.precision_flags()
        model = DenseBox(cfg.model, device="cuda")
        st = create_train_state(model, cfg, device="cuda")
        step = make_train_step(model, cfg, device="cuda")
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(3),
                                32, cfg.label, cfg.train.max_boxes,
                                device="cuda")
        modes = {"port": contextlib.nullcontext, "tf32": tf32_forced}
        step_s = {m: [] for m in modes}
        for turn in range(6):
            for m in (("port", "tf32") if turn % 2 == 0 else ("tf32", "port")):
                with modes[m]():
                    for i in range(5):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        step(st, batch)
                        torch.cuda.synchronize()
                        if turn or i:           # the first step warms up
                            step_s[m].append(time.perf_counter() - t0)
        del model, st, step, batch
        paper = init_model(cfg.model, "cuda")
        imgs = torch.from_numpy(np.stack([np.pad(
            im, ((0, 480 - im.shape[0]), (0, 640 - im.shape[1]), (0, 0)))
            for im in request_images(8, (480, 640), seed=26)])).cuda()
        call_s = {m: [] for m in modes}
        with torch.inference_mode():
            for turn in range(6):
                for m in (("port", "tf32") if turn % 2 == 0
                          else ("tf32", "port")):
                    with modes[m]():
                        call_s[m] += event_seconds(
                            lambda: detect_batch(paper, imgs, cfg.infer,
                                                 cfg.label), 5)
        emit({"phase": "precision_cost", "flags_inside_with_tf32_forced":
              forced, "train_step": {
                  "model": "kitti_vehicle w1.0 f32", "batch": 32, "patch":
                  cfg.label.patch_size, "timing": "host clock, synchronised, "
                  "per step, 6 turns of 5 steps alternating",
                  **{m: quartiles_ms(v) for m, v in step_s.items()}},
              "detect_call": {
                  "model": "kitti_vehicle w1.0 f32", "batch": 8,
                  "canvas": [480, 640], "scales": list(cfg.infer.scales),
                  "timing": "CUDA events per call, 6 turns of 5 calls",
                  **{m: quartiles_ms(v) for m, v in call_s.items()}},
              "bare_step_ms_phase_20": bare_ms, "card": card_line()})
        if forced["cudnn_tf32"] is not True:
            raise AssertionError("TF32 was not forced on for the A/B")
        del paper

        # the bf16 x2 upsample against the CPU, with and without cuBLAS's
        # reduced bf16 reduction: the bf16 paper model's; the int8 chain's
        # (turbo, calibrated on the same images) inside the neck kernel,
        # whose codes are held to the plain version on the CPU
        ups, necks = {}, []

        def capture(fn, key):
            def wrapped(t):
                ups.setdefault(key, t.detach().clone())
                return fn(t)
            return wrapped

        (_, pcfg, _, _), (_, tcfg, _, _) = serving_cells()
        with torch.inference_mode():
            bf16_paper = init_model(pcfg, "cuda")
            for key, batch in (("paper_bf16", imgs),
                               ("paper_bf16_kitti_canvas", x.cuda())):
                with mock.patch.object(dm, "upsample2x_align_corners",
                                       capture(dm.upsample2x_align_corners,
                                               key)):
                    bf16_paper(batch)
            sd = {k: v.cuda() for k, v in float_state(tcfg).items()}
            q = QuantDenseBox(tcfg, device="cuda")
            q.load_state_dict(quantize_densebox(sd, tcfg, imgs))
            neck = mq.int8_neck

            def recorded_neck(*args):
                out = neck(*args)
                necks.append(([t.cpu() for t in args], out.cpu()))
                return out

            with mock.patch.object(mq, "int8_neck", recorded_neck):
                q(imgs)
            result = {k: upsample_vs_cpu(v) for k, v in ups.items()}
        neck_check = {"launches": len(necks), "codes": 0, "differ": 0}
        for args, got in necks:
            neck_check["codes"] += got.numel()
            neck_check["differ"] += int(
                (got != mq.int8_neck(*args)).sum())
        emit({"phase": "precision_bf16_upsample", "canvases": {
                  "paper_bf16": [8, 480, 640], "turbo_int8": [8, 480, 640],
                  "paper_bf16_kitti_canvas": [2, *KITTI_CANVAS]},
              "upsample": result, "turbo_int8_neck_vs_cpu": neck_check})
        if any(r["port"]["differ"] for r in result.values()):
            raise AssertionError(f"the port's bf16 upsample differs from "
                                 f"the CPU's: {result}")
        if not necks or neck_check["differ"]:
            raise AssertionError(f"the int8 neck of the turbo model on the "
                                 f"card differs from its plain version on "
                                 f"the CPU: {neck_check}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "precision_seconds",
          "seconds": time.perf_counter() - t_phase})


def phase_certify() -> None:
    """Phase 22: the certification tool on the card, one short row."""
    import shutil
    import tempfile

    from densebox_tpu_torch.certify import STATS

    root = tempfile.mkdtemp(prefix="densebox_certify_")
    try:
        out = os.path.join(root, "CERT.md")
        cmd = [sys.executable, "-m", "densebox_tpu_torch.certify",
               "--configs", "fast-s2d2-w0.5-lm4", "--steps", "200",
               "--eval-batches", "2", "--workroot", os.path.join(root, "w"),
               "--out", out]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=900)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"certify exited with {res.returncode}: "
                                 f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
        rows = [json.loads(ln) for ln in res.stdout.splitlines()
                if ln.startswith('{"config"')]
        emit({"phase": "certify", "argv": " ".join(cmd[1:]), "rows": rows,
              "wall_s": wall, "card": card_line()})
        emit({"phase": "certify_table",
              "lines": open(out).read().splitlines()})
        if len(rows) != 1:
            raise AssertionError(f"certify printed {len(rows)} rows")
        row = rows[0]
        aps = [row[k]["ap@0.50"] for k in ("bf16", "int8_ptq")]
        dists = row.get("nme_dist", {})
        finite = (all(np.isfinite(aps)) and set(dists) == {"bf16", "int8"}
                  and all(d["n"] > 0 and all(np.isfinite(d[k]) for k in STATS)
                          for d in dists.values()))
        if not finite:
            raise AssertionError(f"certify row not finite: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- the port's bench and its serve load test (phase 23) -----------------

# (run name, bench argv): the README's commands at the published presets
# and batches (480 x 640): turbo int8 B=256, fast int8 B=128 on both int8
# chains, paper bf16 B=64, the turbo landmark pipeline, and the canvas
# train step at turbo's B=256 without and with landmarks
BENCH_RUNS = [
    ("turbo_int8", []),
    ("fast_int8_fused", ["--preset", "fast"]),
    ("fast_int8_hybrid", ["--preset", "fast", "--qbackend", "hybrid"]),
    ("paper_bf16", ["--preset", "paper", "--dtype", "bfloat16"]),
    ("turbo_int8_lm4", ["--landmarks", "4"]),
    ("train_turbo", ["--mode", "train"]),
    ("train_turbo_lm4", ["--mode", "train", "--landmarks", "4"]),
]
LOADTEST_ARGV = ["--turbo-int8", "--clients", "1", "8", "16", "32"]


def run_main(main, argv):
    """(stdout lines, stderr lines) of an entry point's ``main(argv)`` run
    in this process; a failure exit raises with what it printed."""
    import io

    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    except SystemExit as e:
        rc = e.code
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}: {out.getvalue()[-2000:]}"
                             f"{err.getvalue()[-2000:]}")
    return out.getvalue().splitlines(), err.getvalue().splitlines()


def bench_launches(argv, iters):
    """The kernel launches one bench pass of ``iters`` calls or steps should
    make: per detect call one NMS, one int8 conv per conv (and with the
    hybrid chain one requant after each), one window gather with
    landmarks; per train step one box rasterizer and one OHEM per
    classification term (two with the refine branch). The bench's
    synthetic canvases carry no landmarks, as the JAX bench's, so its
    train step never rasterizes them."""
    from densebox_tpu_torch import bench
    from densebox_tpu_torch.models.quant import conv_shapes

    args = bench.parse_args(argv)
    cfg = bench.model_cfg(args, bench.run_shape(args)[2])
    want = dict.fromkeys(("nms", "qconv", "requant", "window",
                          "rasterize_boxes", "rasterize_landmarks", "ohem",
                          "neck"), 0)
    if args.mode == "train":
        want.update(rasterize_boxes=iters,
                    ohem=iters * (2 if cfg.use_refine else 1))
        return want
    n_conv = len(conv_shapes(cfg)) if args.dtype == "int8" else 0
    want.update(nms=iters, qconv=n_conv * iters,
                requant=n_conv * iters if args.qbackend == "hybrid" else 0,
                window=iters if cfg.num_landmarks else 0,
                neck=iters if n_conv and args.qbackend != "xla" else 0)
    return want


def phase_bench():
    """Phase 23: ``python -m densebox_tpu_torch.bench`` in this process
    through its ``main`` at the published presets and batches, one bench
    call of turbo int8 at B=256 held to ``detect_batch`` of its batch, and
    ``python -m densebox_tpu_torch.loadtest --turbo-int8`` at 1, 8, 16 and
    32 clients with every answer held to a detect of its image alone.
    Returns each run's kernel launches of one pass."""
    import torch

    from densebox_tpu_torch import bench, loadtest
    from densebox_tpu_torch.serve import DetectServer

    t_phase = time.perf_counter()
    for name, argv in BENCH_RUNS:
        torch.cuda.empty_cache()
        out, err = run_main(bench.main, argv)
        line, info = json.loads(out[-1]), json.loads(err[-1])
        launches = info["launches_per_pass"]
        want = bench_launches(argv, info["iters"])
        emit({"phase": f"bench_{name}", "argv": " ".join(
            ["python -m densebox_tpu_torch.bench"] + argv), "info": info,
            "launches_expected": want})
        emit(line)
        finite = np.isfinite([line["value"], info.get(
            "checksum", info.get("loss_total_sum"))]).all()
        if (set(line) != {"metric", "value", "unit", "vs_baseline"}
                or line["vs_baseline"] is not None or not line["value"] > 0
                or not finite):
            raise AssertionError(f"bench {name}: {line} {info}")
        if launches != want:
            raise AssertionError(f"bench {name}: launches of one pass "
                                 f"{launches}, want {want}")

    # one call of the headline run, recorded: its detections against a
    # direct detect_batch of the same batch
    calls = []
    real = bench.detect_batch

    def recorded(model, x, icfg, lcfg):
        out = real(model, x, icfg, lcfg)
        calls[:] = [(model, x.clone(), icfg, lcfg,
                     {k: v.clone() for k, v in out.items()})]
        return out

    with mock.patch.object(bench, "detect_batch", recorded):
        run_main(bench.main, ["--iters", "1", "--repeats", "1"])
    model, x, icfg, lcfg, got = calls[0]
    with torch.inference_mode():
        want = bench.detect_batch(model, x, icfg, lcfg)
    equal = {k: bool(torch.equal(got[k], want[k])) for k in want}
    emit({"phase": "bench_call_vs_detect_batch", "batch": list(x.shape),
          "detections": int(want["valid"].sum()), "outputs_equal": equal})
    if not all(equal.values()):
        raise AssertionError(f"a bench call differs from detect_batch of "
                             f"its batch: {equal}")
    del calls[:], model, x, got, want
    torch.cuda.empty_cache()

    # the load test: every answer against a detect of its image alone in
    # slot 0 of a zero batch, through the server's own detect function
    answers = []
    submit = DetectServer.submit

    def recorded_submit(self, img, timeout=60.0):
        res = submit(self, img, timeout)
        answers.append((self, img, res))
        return res

    reset_launches()
    with mock.patch.object(DetectServer, "submit", recorded_submit):
        out, _ = run_main(loadtest.main, LOADTEST_ARGV)
    launches = read_launches()
    levels = [json.loads(ln) for ln in out if ln.startswith("{")]
    alone, differ = {}, 0
    for server, img, res in answers:
        key = img.tobytes()
        if key not in alone:
            batch = alone_batch(img, server.max_batch, server.canvas_hw)
            alone[key] = slot_detections(server._detect(batch.cuda()), 0)
        differ += mismatch(res, alone[key]) is not None
    calls_all = sum(lv["device_calls"] for lv in levels)
    # each fresh server's warm-up call is one device call more
    want = {"nms": calls_all + len(levels), "qconv": 14 * (calls_all
                                                           + len(levels))}
    for lv in levels:
        emit({"phase": "loadtest", **lv})
    emit({"phase": "loadtest_check", "argv": " ".join(
        ["python -m densebox_tpu_torch.loadtest"] + LOADTEST_ARGV),
        "answers": len(answers), "distinct_images": len(alone),
        "answers_not_as_alone_in_slot_0": differ, "launches": launches,
        "launches_expected": want})
    # one closed-loop client has nothing to share a call with: every
    # request is a device call of its own; more clients coalesce
    if ([lv["clients"] for lv in levels] != [1, 8, 16, 32]
            or any(lv["requests"] != 96 or not (
                lv["device_calls"] < 96 if lv["clients"] > 1
                else lv["device_calls"] == 96) for lv in levels)
            or len(answers) != 96 * len(levels)):
        raise AssertionError(f"load test: {levels}")
    if differ:
        raise AssertionError(f"load test: {differ} answers differ from a "
                             f"detect of their image alone in slot 0")
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"load test launches {launches}, want {want}")
    # every conv batch shape this process found slot-dependent (and ran
    # one image a call), over all phases so far
    from densebox_tpu_torch.models import densebox as mdb

    emit({"phase": "slot_dependent_conv_shapes", "shapes": sorted(
        f"{str(dtype).split('.')[-1]} {list(shape)} w{list(wshape)}"
        for (_, dtype, shape, wshape, _), safe in mdb._slot_safe.items()
        if not safe)})
    emit({"phase": "bench_seconds", "seconds": time.perf_counter() - t_phase})


# --- the kernels against their plain versions (phase 24) -------------------

# (name, counter, source in csrc/, the TPU kernel it replaces (none for the
# int8 neck), the main-path run whose launches the kernels line reads, the
# shape of its bound: PERF.md's table of kernels)
KERNEL_ROWS = [
    ("greedy_nms_keep", "nms", "nms", "nms.py:28", "serve_paper_bf16",
     "B=8, K=512, random set"),
    ("qconv_int8", "qconv", "qconv", "qconv.py:59", "serve_turbo_int8_fused",
     "turbo conv3_2, B=8, int8 out"),
    ("requant_epilogue", "requant", "requant", "requant.py:35",
     "serve_turbo_int8_hybrid", "8x120x160x64, int8 out"),
    ("gather_windows", "window", "window", "window.py:53", "serve_malf_bf16",
     "MALF: B=8, D=64, L=5, win 32, bf16"),
    ("rasterize_boxes", "rasterize_boxes", "labels", "labels.py:46",
     "train_kitti_vehicle", "B=32, K=16, M=60"),
    ("rasterize_landmarks", "rasterize_landmarks", "labels", "labels.py:79",
     "train_malf_face", "B=32, K=16, L=5, M=60"),
    ("ohem_select", "ohem", "ohem", "ohem.py:53", "train_kitti_vehicle",
     "B=32, P=3600, errors of a forward"),
    ("int8_neck", "neck", "neck", None, "serve_turbo_int8_fused",
     "kitti's 4 scales of 480x640, B=8, a call")]


def phase_kernels(launches):
    """Phase 24: each kernel (see the docstring) against its plain version
    at the main path's shapes, and the kernels line."""
    import torch

    from densebox_tpu_torch import LabelCfg
    from densebox_tpu_torch.ops.kernels import labels as kl
    from densebox_tpu_torch.ops.kernels import neck as kneck
    from densebox_tpu_torch.ops.kernels import nms as knms
    from densebox_tpu_torch.ops.kernels import ohem as ko
    from densebox_tpu_torch.ops.kernels import qconv as kq
    from densebox_tpu_torch.ops.kernels import requant as kr
    from densebox_tpu_torch.ops.kernels import window as kw

    cases, differ, bounds = {}, [], {}

    def check(counter, case, got, want):
        got, want = (tuple(t) if isinstance(t, (tuple, list)) else (t,)
                     for t in (got, want))
        torch.cuda.synchronize()
        cases[counter] = cases.get(counter, 0) + 1
        if len(got) != len(want) or not all(map(bits_equal, got, want)):
            differ.append(f"{counter} {case}")

    for b, k in NMS_SHAPES:
        boxes, valid = nms_set("random", b, k, seed=1)
        tb, tv = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        check("nms", f"B{b} K{k}", knms.greedy_keep(tb, tv, 0.5),
              knms.greedy_keep_reference(tb, tv, 0.5))
        if (b, k) == (8, 512):
            bounds["nms"] = nms_bound(valid)
    rng = np.random.RandomState(5)
    for name, *shape in QCONV_CASES:
        # the mode the main path runs the layer in: int8 codes out, f32
        # from the heads' conv2; kitti's B=64 launch compared on 2 rows
        x, wq, scale, bias, osc = qconv_inputs(rng, *shape, "cuda")
        kw_ = dict(relu=False) if shape[4] <= 4 else dict(out_scale=osc)
        rows = 2 if name in KITTI_OFFLINE else shape[0]
        kq.reset_launches()
        got = kq.qconv_int8(x, wq, scale, bias, **kw_)[:rows]
        if kq.variant_launches != {kq.kernel_variant(*shape[3:]): 1}:
            differ.append(f"qconv {name} variant {kq.variant_launches}")
        check("qconv", name, got,
              kq.qconv_reference(x[:rows], wq, scale, bias, **kw_))
        del x, got
    shapes = {name: shape for name, *shape in QCONV_CASES}
    bounds["qconv"] = qconv_bound(*shapes["turbo_conv3_2"])
    rng = np.random.RandomState(6)
    for name, b, h, w, _, cout, _ in QCONV_CASES:
        if name not in TURBO_LAUNCHES:      # the hybrid call's 14 launches
            continue
        acc = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, (b, h, w, cout))
                               .astype(np.int32)).cuda()
        vecs = [torch.from_numpy(rng.uniform(lo, hi, cout).astype(np.float32))
                .cuda() for lo, hi in ((1e-6, 3e-6), (-0.5, 0.5), (20, 40))]
        args = (acc, vecs[0], vecs[1], None if cout <= 4 else vecs[2])
        check("requant", name, kr.requant_epilogue(*args, relu=cout > 4),
              kr.requant_reference(*args, relu=cout > 4))
    bounds["requant"] = requant_bound(8 * 120 * 160 * 64, 64)
    rng = np.random.RandomState(13)
    for name, *shape, shared in WINDOW_CASES:
        inputs = window_inputs(rng, *shape, shared, torch.bfloat16)
        check("window", name, kw.gather_windows(*inputs, shape[-1]),
              kw.gather_windows_reference(*inputs, shape[-1]))
    b, _, num_lm, _, _, d, win = WINDOW_CASES[0][1:-1]
    bounds["window"] = window_bound(b, num_lm, d, win)
    b, k, m, num_lm = TRAIN_RASTER
    rows, lm_rows = (torch.from_numpy(a).cuda() for a in label_rows(
        np.random.RandomState(17), b, k, m, num_lm))
    inv = float(np.float32(1.0 / LabelCfg().loc_norm))
    want = kl.rasterize_boxes_reference(rows, m, inv)
    want_lm = kl.rasterize_landmarks_reference(lm_rows, m, num_lm)
    check("rasterize_boxes", "alone", kl.rasterize_boxes(rows, m, inv), want)
    check("rasterize_landmarks", "alone",
          kl.rasterize_landmarks(lm_rows, m, num_lm), want_lm)
    check("rasterize_landmarks", "both maps in one launch",
          kl.rasterize_maps(rows, lm_rows, m, inv, num_lm),
          tuple(want) + (want_lm,))
    bounds["rasterize_boxes"], bounds["rasterize_landmarks"] = \
        rasterizer_bounds(rows, lm_rows, m, num_lm)
    args = ohem_forward_case(32)
    check("ohem", "forward", ko.ohem_select(*args, 1.0, 0.5, 16),
          ko.ohem_select_reference(*args, 1.0, 0.5, 16))
    bounds["ohem"] = ohem_bound(*args[0].shape)
    s3 = torch.tensor(0.0173, device="cuda")
    for b in (8, 64):
        levels = neck_levels(b, seed=b)
        for so in (2.0 ** -5, 0.0219):     # on exact halves, and arbitrary
            so = torch.tensor(so, device="cuda")
            for f3, f4 in levels:
                check("neck", f"B{b} {tuple(f3.shape[1:3])}",
                      kneck.int8_neck(f3, f4, s3, so),
                      kneck.neck_reference(f3, f4, s3, so))
        if b == 8:
            bounds["neck"] = neck_bound(levels)[:2]
        del levels
        torch.cuda.empty_cache()
    emit({"phase": "kernels_against_plain", "cases_equal": cases,
          "differing": differ})
    if differ:
        raise AssertionError(f"kernels differ from their plain versions: "
                             f"{differ}")
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"densebox_tpu_torch/csrc/{src}.cu",
         "replaces": (f"densebox_tpu/ops/pallas/{tpu}" if tpu
                      else "none: XLA fused these steps"),
         "launches": launches[run][counter], "launches_run": run,
         "cases_equal_to_plain": cases[counter],
         "bound_shape": shape, "bound_ms": bounds[counter][0],
         "bound_by": bounds[counter][1]}
        for name, counter, src, tpu, run, shape in KERNEL_ROWS]})


def cv2_version():
    """cv2's version where it imports, else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import densebox_tpu_torch  # noqa: F401  (alone, without the repo: fail here, silent)

    from densebox_tpu_torch.device import precision_flags

    # the script sets no precision flag: the port holds the reference's
    # precision itself (phase 21), and leaves the flags as it found them
    TORCH_DEFAULTS.update(precision_flags())

    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phase_build()
    phase_forward()
    launches = {}           # run -> its kernels' launch counts
    for name, *cfgs in serving_cells():
        run = f"serve_{name}_bf16"
        launches[run] = phase_serve(run, *cfgs)
    phase_forward_int8()
    _, turbo, turbo_infer, label = serving_cells()[1]
    for quant in ("fused", "hybrid"):
        run = f"serve_turbo_int8_{quant}"
        launches[run] = phase_serve(run, turbo, turbo_infer, label,
                                    quant=quant)
    phase_decode_card_vs_cpu()
    for name, *cfgs, quant in landmark_cells():
        launches[f"serve_{name}"] = phase_serve(
            f"serve_{name}", *cfgs, quant=quant, loc_bias=1.0)
    phase_step_card_vs_cpu()
    phase_step_repeats()
    (_, kitti), (_, malf) = train_cfgs()
    launches["train_kitti_vehicle"], bare_ms = phase_train(
        "kitti_vehicle", kitti, 30, False)
    launches["train_malf_face"], _ = phase_train("malf_face", malf, 12, True)
    phase_fit()
    phase_cli(bare_ms)
    phase_multi_device(bare_ms)
    phase_xla_int8()
    phase_export()
    phase_precision(bare_ms)
    phase_certify()
    phase_bench()
    phase_kernels(launches)
    flags = precision_flags()
    emit({"phase": "precision_flags_at_end", "flags": flags,
          "torch_defaults": TORCH_DEFAULTS})
    if flags != TORCH_DEFAULTS:
        raise AssertionError(f"the precision flags end as {flags}, not as "
                             f"torch started: {TORCH_DEFAULTS}")
    emit({"phase": "seconds", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
