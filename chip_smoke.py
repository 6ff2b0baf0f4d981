#!/usr/bin/env python3
"""Drive the PyTorch port's detect-and-serve and train paths, and its command
line, once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises, so the exit code is
not 0):
  1. no card, no run: without CUDA the script exits 1 with no result;
  2. the card's name and power limit (nvidia-smi);
  3. build the CUDA kernels (NMS, int8 conv, requant, window gather, GT
     rasterizers, OHEM, the int8 neck, and the empty kernel the launch
     floors are timed with) from densebox_tpu_torch/csrc, one nvcc per
     source, all at once;
  4. NMS kernel against its plain PyTorch version on the card (B=8,
     K in {256, 512, 1024}, random boxes and IoU-on-threshold pairs: keep
     masks, indices, boxes and scores identical; then keep masks on every
     set of ``nms_set`` at B=1 and 8 with K from 1 to 1024, and at B=256,
     K=256 and B=64, K=512), with median times, and device times
     (CUDA-graph replay, the graph's mask equal to the eager call's) at
     the main path's shapes on a random, an all-kept and a chained set,
     beside the bound and an empty launch of the same grid;
  5. the paper model (width 1.0) forward in f32 on the card against the
     port on the CPU (1e-3 absolute), then a bf16 forward;
  6. serve: a DetectServer with the paper model in bf16, 480x640 canvas,
     max_batch 8, the preset's 4-scale pyramid; 24 requests from 8 threads,
     answered, coalesced, and each equal bit for bit to a direct
     detect_batch of its image alone in slot 0 of a zero batch of 8, as
     is each of the first 8 images detected in its slot of a batch of 8
     different images (``DenseBox._conv`` runs a batch that cuDNN would
     compute differently by slot one image a call: the bf16 512-channel
     convs at the 0.7071 and 0.3536 levels);
  7. the same serve run with the turbo trunk (s2d4, depth 3, width 0.25);
  8. int8 conv kernel against its plain version on the card, in its three
     output modes, at every layer shape of the turbo model (B=8), paper
     shapes and the edges of its variants (Cout 1 and 5, Cin 5, 6 and 768,
     maps that are no multiple of the tile, B=1): outputs identical and
     the variant launched the one ``kernel_variant`` names; then, on a line
     of its own, the device time of every turbo layer (20 launches replayed
     as a CUDA graph between one pair of events) beside its bound and the
     same values through a bf16 ``F.conv2d``, and their sum over the 14
     launches of a device call, and for the 1x1 layers whose widths
     cuBLASLt takes, ``torch._int_mm`` of the same operands (the int32
     accumulator only, no epilogue);
  9. requant kernel against its plain version (B=8, 120x160x64, int8 and
     f32 outputs): identical; median times; then, on a line of its own, its
     device time at the accumulator of every conv of a hybrid device call
     of the turbo model beside that shape's bound, and their sums over the
     call's 14 launches;
 10. the paper model in int8, calibrated on the card: its forward on the
     card against the plain versions on the CPU with the same int8 state
     (B=2, 240x320): every int8 code and map identical; the fused and the
     hybrid chain identical on the card; the forward's time on the card;
     then the int8 neck kernel against its plain version on the card at
     kitti's four scales of a 480x640 canvas (B=8 and 64, 256 + 512
     channels, an output scale of 2^-5 and an arbitrary one): every code
     identical; event times of a call's four launches, the plain
     version's, and device times by CUDA-graph replay beside the bound of
     the call's bytes;
 11. serve the turbo model in int8 (calibrated on the card from the canvas
     batch, one scale), as phase 7: served equal to alone, one int8 conv
     launch per conv per device call, all 14 on the tensor-core variant,
     one NMS and one int8 neck launch per device call;
 12. the same with the hybrid chain (int32 conv, then requant);
 13. window-gather kernel against its plain version on the card, bitwise,
     in bf16 and f32: the MALF serve shape (B=8, S=5, L=5, 170x228, D=64,
     win 32, per-landmark origins), the bench's lm4 shape (B=8, S=1, L=4,
     120x160, shared origins), a ragged one (win 17, odd map, D=5: the
     element copy), a short one (win 8) and windows on every edge of an odd
     map at every column offset modulo 8, from maps that start off a 16-byte
     boundary (win 8, 17, 32; shared and per-landmark origins), and origins
     outside the map (moved into it, as by the plain version); which of the
     two copies ran; device times (CUDA-graph replay) at the first two
     shapes beside the byte bound and an empty launch of the same grid;
 14. landmark decode, card against CPU: the malf_face() model (width 1.0,
     5 landmarks, refine) in bf16 runs its 5-scale pyramid once on the card
     (B=2, 240x320); everything after the forward (decode, cap, NMS, scale
     selection, landmark decode) then runs on those maps on the card and on
     the CPU: boxes, scores, validity and landmarks identical, and the
     'std' scale selection counted where it differs;
 15. serve malf_face() in bf16 (480x640 canvas, max_batch 8, its pyramid
     and anchors, lm_topk 64), as phase 6: served equal to a direct
     detect_batch of the image alone bit for bit, landmarks included; one
     NMS and one window launch per device call;
 16. serve the bench's landmark pipeline in int8: the turbo trunk with 4
     landmarks and refine, no anchors (shared origins), calibrated on the
     card, one scale: as phase 15, plus one int8 conv launch per conv;
 17. both GT rasterizer kernels, each alone and the two as one launch,
     against their plain versions on the card, bitwise: packed rows at the
     training shape (B=32, K=16, M=60, L=5; out of band and invalid slots,
     an empty patch, coincident and equidistant centres, rim-exact discs), a
     ragged one (B=3, K=1, M=8, L=1), the training shape with every centre
     and radius on the quarter-pixel grid and landmark radii other than 1,
     with every slot invalid, 125 x 125 maps with K = 1024 box rows and with
     K * L = 1024 landmark rows, and a landmark centre at every quarter
     pixel across each edge of a block's chunk of the output, inside and
     outside the map; then px boxes through ``rasterize`` on the card
     against the CPU; event and device times at the training shape beside
     an empty launch of each kernel's grid, and two launches against one
     for a step's two maps;
 18. OHEM kernel against its plain version on the card, bitwise, at B=32,
     P=3600: random errors, all negatives tied, no positives, fewer
     candidates than the quota, the errors of a real forward, and candidate
     sets of 0, 1, the quotas and one more, around 256, and the whole
     sample; two launches against one stacked launch for a step's two
     terms; the floors: an empty launch of the same grid, and the chain of
     block-wide rounds (those the worst sample of this run needs by the
     schedule's numpy model, at the measured time of one round; the levels
     one warp walks alone are counted beside it and not timed);
 19. one train step, card against CPU: kitti_vehicle() and malf_face() at
     full width in f32, B=4, 240 px, the same state, batch and given draws:
     GT maps identical, OHEM masks identical on the same errors, loss and
     metrics within 1e-4 relative, every gradient within 5e-3 of its largest
     entry (cuDNN sums in another order than the CPU; a float64 step on the
     CPU shows float32's own rounding noise beside it); then the step at
     B=32 (malf_face through the canvas step) taken twice from the same
     parameters, momentum and generator state: parameters, momentum, loss
     and update norm identical bit for bit; ms/step with the step's cuDNN
     pinning and with it taken out, in turns;
 20. train kitti_vehicle() at full width, B=32, 240 px patches: 2 + 30
     steps of make_train_step on synthetic batches drawn on the card; every
     loss and update norm finite, the mean loss of the last 5 steps below
     that of the first 5, parameters moved, per step 1 box-rasterizer
     launch, 0 landmark launches and 1 OHEM launch; ms/step and steps/s on
     the host clock (synchronised) on a line of their own;
 21. train malf_face() at full width (5 landmarks, refine) through
     make_canvas_train_step: 480 px canvases, 240 px patches sampled on the
     card with flips, B=32, 2 + 12 steps: as phase 20, with 1 + 1 rasterizer
     launches (one launch for the two maps) and 2 OHEM launches per step;
 22. ``fit`` on kitti_vehicle() at full width, B=32, 240 px, on the card by
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
 23. the command line (``densebox_tpu_torch/cli.py``) as a user runs it, on
     a KITTI-format directory written here: 64 PNG scenes at KITTI's
     375 x 1242 (this script's own PNG writer, filter 0) with 1-6
     Car/Van/Truck boxes each plus DontCare lines. ``train`` in-process at
     the CLI's defaults (full-width kitti_vehicle, f32, B=32, 240 px patches
     from 384 x 1248 canvases), 12 steps, a checkpoint every 6: rc 0, the
     logged losses finite, two checkpoints, 12 box-rasterizer and 12 OHEM
     launches, the loader's backend and how many steps waited on it, ms/step
     beside phase 20's; the loader alone (batches/s, with the decoder the
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
 24. multi-device (``parallel/``), kitti_vehicle() at full width, f32: (a)
     a one-rank NCCL group in this process: the sharded train step
     at B=32, 240 px equal bit for bit to the bare step of the same state,
     batch and draws (parameters, momentum, every metric); both timed in
     turns; ``fit(use_mesh=True)`` 8 steps with checkpoints, ms/step; (b)
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
 25. the turbo_int8 cell (B=8, 480 x 640, one scale) with
     ``QuantDenseBox(backend='xla')`` (the JAX package's default chain):
     every int8 code, int32 accumulator and map on the card equal to the
     CPU's; 14 ``qconv_int8`` launches per device call, all in int32 mode,
     no ``requant_epilogue``; the device call of 'fused' and 'xla' timed in
     turns, median (q1, q3);
 26. export (``densebox_tpu_torch/export.py``) of the turbo_int8, paper and
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
 27. precision: the port computes at the reference's precision by itself
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
 28. certification: ``python -m densebox_tpu_torch.certify`` as a
     subprocess for fast-s2d2-w0.5-lm4 at 200 steps and 2 eval batches:
     one JSON row with finite AP@0.50 in bf16 and int8 and a finite
     landmark error distribution, and its wall time;
 29. the port's bench and load test, as a user runs them: ``python -m
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
     call (warm-ups included).
At the end torch's three precision flags read as they did at the start.
Each serve and train run resets every kernel's launch counter just before
its requests or steps and reads them just after. The line before the last
lists the eight kernels (with the least time the card could take for the
same bytes or operations, from the published peaks of an H100 SXM, and one
PyTorch call's time where one computes the same function; ``ms`` is device
time by CUDA-graph replay for the int8 conv, the window gather, the
rasterizers and OHEM, which also carry ``floor_ms``, an empty launch of their
grid; the int8 neck's ``ms`` is event time, and it carries its device time
by replay as ``device_ms`` and its B=64 call as ``B64``; and their launches on the paths of phases 24-26 as
``launches_<run>``), after the card line again and the script's seconds;
the last line is {"ok": true, "device": {...}}.

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

REPO = os.path.dirname(os.path.abspath(__file__))
# csrc/<name>.cu; floor.cu is the empty kernel the launch floors are timed with
KERNELS = ("nms", "qconv", "requant", "window", "labels", "ohem", "neck",
           "floor")


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


def median_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    return float(np.median(event_seconds(fn, reps))) * 1e3


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


def random_case(rng, b, k):
    """Clustered boxes (many overlaps) with score ties and invalid slots."""
    ctr = rng.uniform(0, 640, (b, k, 2)) * np.array([1.0, 0.75])
    ctr = np.round(ctr / 40) * 40 + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(8, 120, (b, k, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, (b, k)), 2).astype(np.float32)
    valid = rng.uniform(size=(b, k)) > 0.15
    return boxes, scores, valid


def threshold_case(rng, b, k, integer_frac=0.5):
    """Pairs whose IoU is 0.5 in exact arithmetic: integer pairs where f32
    gives exactly 0.5 (kept), and float pairs shifted by a third of their
    width, which f32 rounds to either side of 0.5."""
    n = k // 2
    x = rng.uniform(0, 600, (b, n)).astype(np.float32)
    y = rng.uniform(0, 400, (b, n)).astype(np.float32)
    w = rng.uniform(6, 90, (b, n)).astype(np.float32)
    h = rng.uniform(6, 90, (b, n)).astype(np.float32)
    integer = rng.uniform(size=(b, n)) < integer_frac
    x, y, w, h = (np.where(integer, np.round(v), v) for v in (x, y, w, h))
    w = np.where(integer, 3 * np.maximum(np.round(w / 3), 1), w)
    a = np.stack([x, y, x + w, y + h], -1)
    s = (w / 3).astype(np.float32)       # IoU(a, a + s) = (w-s)/(w+s) = 1/2
    p = np.stack([x + s, y, x + w + s, y + h], -1)
    boxes = np.stack([a, p], 2).reshape(b, 2 * n, 4)
    if k > 2 * n:
        boxes = np.concatenate([boxes, np.zeros((b, k - 2 * n, 4))], 1)
    scores = np.linspace(1.0, 0.0, k, dtype=np.float32)[None].repeat(b, 0)
    return boxes.astype(np.float32), scores, np.ones((b, k), bool)


NMS_SETS = ("random", "disjoint", "identical", "chain", "threshold",
            "interleaved_invalid", "all_invalid")
# (B, K) of the NMS calls timed: serving at B=8, the bench's turbo and paper
NMS_SHAPES = ((8, 256), (8, 512), (8, 1024), (256, 256), (64, 512))


def nms_set(name, b, k, seed=0):
    """(boxes (B, K, 4) f32 in score order, valid (B, K) bool) of one of the
    NMS kernel's test sets (``NMS_SETS``): ``random_case``; no two boxes
    overlapping (all kept); one box K times (the first kept); a chain of
    10-pixel boxes 2 pixels apart, each suppressing the next (IoU 2/3) and
    not the one after (3/7), so every other box stays and the greedy order
    is one chain K long; ``threshold_case`` (pairs at IoU 0.5); the chain
    with every third box invalid; and every box invalid."""
    rng = np.random.RandomState(seed)
    if name in ("random", "all_invalid"):
        boxes, _, valid = random_case(rng, b, k)
        return boxes, valid & (name == "random")
    if name == "threshold":
        boxes, _, valid = threshold_case(rng, b, k)
        return boxes, valid
    n = np.arange(k, dtype=np.float32)
    y = rng.randint(0, 400, (b, 1)).astype(np.float32) + 0 * n
    step = {"disjoint": 4, "identical": 0}.get(name, 2)
    x = rng.randint(0, 100, (b, 1)).astype(np.float32) + step * n
    size = 2 if name == "disjoint" else 10
    boxes = np.stack([x, y, x + size, y + size], -1).astype(np.float32)
    valid = np.ones((b, k), bool)
    if name == "interleaved_invalid":
        valid[:, 1::3] = False
    return boxes, valid


def phase_nms():
    import torch

    from densebox_tpu_torch.ops.kernels import nms as knms
    from densebox_tpu_torch.ops.nms import nms

    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cases = [("random", k, random_case(rng, 8, k)) for k in (256, 512, 1024)]
    cases += [("iou_on_threshold", k, threshold_case(rng, 8, k))
              for k in (256, 512, 1024)]
    err, results = 0.0, []
    for name, k, (boxes, scores, valid) in cases:
        b_cpu, s_cpu, v_cpu = (torch.from_numpy(a) for a in (boxes, scores, valid))
        b_gpu, s_gpu, v_gpu = (t.to(dev) for t in (b_cpu, s_cpu, v_cpu))
        # keep mask: kernel vs plain version, same inputs on the card
        order = torch.sort(torch.where(v_gpu, s_gpu, float("-inf")), dim=1,
                           descending=True, stable=True).indices
        sb = torch.gather(b_gpu, 1, order[..., None].expand(-1, -1, 4))
        sv = torch.gather(v_gpu, 1, order)
        keep = knms.greedy_keep(sb, sv, 0.5)
        keep_ref = knms.greedy_keep_reference(sb, sv, 0.5)
        torch.cuda.synchronize()
        n_diff = int((keep != keep_ref).sum())
        # whole NMS: kernel path on the card vs plain path on the CPU
        got = nms(b_gpu, s_gpu, v_gpu, iou_thresh=0.5, max_out=128,
                  return_idx=True)
        want = nms(b_cpu, s_cpu, v_cpu, iou_thresh=0.5, max_out=128,
                   return_idx=True)
        got = [t.cpu() for t in got]
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        fin = torch.isfinite(want[1])
        box_err = float((got[0] - want[0]).abs().max())
        err = max(err, float(n_diff), box_err,
                  float((got[1][fin] - want[1][fin]).abs().max()))
        results.append({"case": name, "B": 8, "K": k, "kept": int(keep.sum()),
                        "keep_mismatches": n_diff, "nms_outputs_equal": same})
        if n_diff or not same:
            emit({"phase": "nms_kernel", "results": results})
            raise AssertionError(f"NMS kernel disagrees with its plain "
                                 f"version ({name}, K={k})")
    # keep masks on every set of the schedule model
    # (tests/test_torch_nms_schedule.py), at B=1 and 8, and at the bench's
    # B=256, K=256 and B=64, K=512
    shapes = [(b, k) for k in (1, 63, 64, 65, 97, 100, 256, 512, 1024)
              for b in (1, 8)] + [(256, 256), (64, 512)]
    bad = []
    for name in NMS_SETS:
        for b, k in shapes:
            boxes, valid = nms_set(name, b, k, seed=k)
            tb = torch.from_numpy(boxes).to(dev)
            tv = torch.from_numpy(valid).to(dev)
            n_diff = int((knms.greedy_keep(tb, tv, 0.5)
                          != knms.greedy_keep_reference(tb, tv, 0.5)).sum())
            if n_diff:
                bad.append({"set": name, "B": b, "K": k,
                            "keep_mismatches": n_diff})
    results.append({"case": "sets", "sets": list(NMS_SETS),
                    "shapes": shapes, "keep_mismatches": len(bad),
                    "failed": bad})
    if bad:
        emit({"phase": "nms_kernel", "results": results})
        raise AssertionError(f"NMS kernel disagrees with its plain version "
                             f"on {len(bad)} set(s)")
    times = {}
    for k in (256, 512):
        boxes, scores, valid = random_case(rng, 8, k)
        sb = torch.from_numpy(boxes).to(dev)
        sv = torch.from_numpy(valid).to(dev)
        times[k] = (median_ms(lambda: knms.greedy_keep(sb, sv, 0.5), 50),
                    median_ms(lambda: knms.greedy_keep_reference(sb, sv, 0.5), 7))
        if k == 512:
            bound_512 = nms_bound(valid)
    # device time by CUDA-graph replay (one launch a call, no other host
    # call: the graph's mask must equal the eager call's), beside the bound
    # and an empty launch of the same grid
    dev_ms = {}
    for b, k in NMS_SHAPES:
        for name in ("random", "disjoint", "chain"):
            boxes, valid = nms_set(name, b, k, seed=1)
            tb = torch.from_numpy(boxes).to(dev)
            tv = torch.from_numpy(valid).to(dev)
            eager = knms.greedy_keep(tb, tv, 0.5)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = knms.greedy_keep(tb, tv, 0.5)
            graph.replay()
            if not torch.equal(captured, eager):
                raise AssertionError(f"NMS kernel in a CUDA graph differs "
                                     f"({name}, B={b}, K={k})")
            dev_ms[f"{name}_B{b}_K{k}"] = {
                "device_ms": device_ms(lambda: knms.greedy_keep(tb, tv, 0.5)),
                "kept": int(eager.sum()), "bound_ms": nms_bound(valid)[0]}
        cluster, threads = knms.launch_shape(b, k)
        dev_ms[f"floor_B{b}_K{k}"] = empty_launch_ms(cluster, b, threads)
    emit({"phase": "nms_kernel", "results": results, "max_abs_err": err,
          "median_ms": {f"B8_K{k}": {"kernel": t[0], "plain": t[1]}
                        for k, t in times.items()},
          "device": dev_ms, "bound_by": "operations"})
    return err, times[512], bound_512, None, {
        "floor_ms": dev_ms["floor_B8_K512"]}


def nms_bound(valid):
    """(bound_ms, bound_by) of one ``greedy_keep`` call: boxes and flags in,
    the keep mask out, and 16 float operations for the IoU test of each pair
    of valid boxes (the kernel tests no other pair)."""
    b, k = valid.shape
    n = valid.sum(1).astype(np.float64)
    return bound(b * k * (16 + 1 + 1), float((n * (n - 1) / 2).sum()) * 16)


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


# (name, B, H, W, Cin, Cout, k): every int8 conv shape of the turbo model at
# the serving batch (trunk at 120x160 and, after the pool, 60x80; the heads'
# 1x1 convs), paper conv1_1 and conv4_2 (B=2 keeps the plain version short),
# then the edges of the kernel's variants: W=33 and Cin=5 (the CUDA-core
# variant), Cout 1 and 5 (masked scalar stores), Cin 6 (refine_conv1), Cin
# 768 (the paper's head conv1: weights streamed in chunks, at a small map),
# a map whose height and width are no multiple of the 8x16 tile, and B=1;
# then kitti's offline launches at B=64 (the warpgroup variant), timed
# against their least time in KITTI_OFFLINE (the reference is checked on
# their first two images)
QCONV_CASES = [
    ("turbo_conv1_1", 8, 120, 160, 48, 16, 3),
    ("turbo_conv1_2", 8, 120, 160, 16, 16, 3),
    ("turbo_conv2_1", 8, 120, 160, 16, 32, 3),
    ("turbo_conv2_2", 8, 120, 160, 32, 32, 3),
    ("turbo_conv3_1", 8, 120, 160, 32, 64, 3),
    ("turbo_conv3_2", 8, 120, 160, 64, 64, 3),
    ("turbo_conv4_1", 8, 60, 80, 64, 128, 3),
    ("turbo_conv4_2", 8, 60, 80, 128, 128, 3),
    ("turbo_head_conv1", 8, 120, 160, 192, 128, 1),
    ("turbo_det_conv2", 8, 120, 160, 128, 1, 1),
    ("turbo_loc_conv2", 8, 120, 160, 128, 4, 1),
    ("paper_conv1_1", 2, 240, 320, 3, 64, 3),
    ("paper_conv4_2", 2, 30, 40, 512, 512, 3),
    ("ragged", 3, 13, 33, 5, 24, 3),
    ("malf_lm_conv2", 2, 60, 80, 512, 5, 1),
    ("malf_refine_conv1", 2, 60, 80, 6, 64, 3),
    ("paper_head_conv1", 1, 30, 40, 768, 512, 1),
    ("off_tile", 2, 27, 45, 64, 64, 3),
    ("batch_1", 1, 120, 160, 64, 64, 3),
    ("kitti_conv2_2", 64, 240, 320, 128, 128, 3),
    ("kitti_conv3_2", 64, 120, 160, 256, 256, 3),
    ("kitti_conv4_2", 64, 60, 80, 512, 512, 3),
    ("kitti_head_conv1", 64, 120, 160, 768, 512, 1),
]
KITTI_OFFLINE = ("kitti_conv2_2", "kitti_conv3_2", "kitti_conv4_2",
                 "kitti_head_conv1")
# how often a device call of the turbo int8 model launches each timed shape
# (conv3_2 = conv3_3, conv4_2 = conv4_3, det and loc conv1): 14 in all; the
# output mode it is timed in is the model's (f32 from the heads' conv2)
TURBO_LAUNCHES = {"turbo_conv1_1": 1, "turbo_conv1_2": 1, "turbo_conv2_1": 1,
                  "turbo_conv2_2": 1, "turbo_conv3_1": 1, "turbo_conv3_2": 2,
                  "turbo_conv4_1": 1, "turbo_conv4_2": 2,
                  "turbo_head_conv1": 2, "turbo_det_conv2": 1,
                  "turbo_loc_conv2": 1}


def qconv_inputs(rng, b, h, w, cin, cout, k, dev):
    """Int8 activations and weights over the whole code range, and epilogue
    vectors that put y at a few units, so that int8 outputs round and
    clip."""
    import torch

    x = rng.randint(-127, 128, (b, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (cout, k, k, cin)).astype(np.int8)
    spread = 127.0 * 127.0 * np.sqrt(k * k * cin)
    vecs = [rng.uniform(1.0, 3.0, cout) / spread, rng.uniform(-0.5, 0.5, cout),
            rng.uniform(20.0, 40.0, cout)]
    return [torch.from_numpy(a).to(dev)
            for a in [x, wq] + [v.astype(np.float32) for v in vecs]]


def phase_qconv():
    import torch

    from densebox_tpu_torch.ops.kernels import qconv as kq

    rng = np.random.RandomState(5)
    results, err, layers, row2, kitti = [], 0.0, {}, None, {}
    for name, *shape in QCONV_CASES:
        b, h, w, cin, cout, k = shape
        x, wq, scale, bias, osc = qconv_inputs(rng, *shape, "cuda")
        modes = {"int8": dict(out_scale=osc), "f32": dict(relu=False),
                 "int32": dict(out="int32")}
        variant = kq.kernel_variant(cin, cout, k)
        row = {"case": name, "shape": shape, "variant": variant}
        rows = 2 if name in KITTI_OFFLINE else b
        for mode, kw in modes.items():
            kq.reset_launches()
            got = kq.qconv_int8(x, wq, scale, bias, **kw)[:rows]
            want = kq.qconv_reference(x[:rows], wq, scale, bias, **kw)
            torch.cuda.synchronize()
            diff = float((got.double() - want.double()).abs().max())
            row[mode] = {"equal": bool(torch.equal(got, want)),
                         "max_abs_err": diff}
            err = max(err, diff)
            if not row[mode]["equal"] or kq.variant_launches != {variant: 1}:
                emit({"phase": "qconv_kernel", "results": results + [row],
                      "variant_launches": kq.variant_launches})
                raise AssertionError(f"int8 conv kernel disagrees with its "
                                     f"plain version or took another "
                                     f"variant ({name}, {mode})")
        row["plan"] = dict(kq.last_plan)
        results.append(row)
        if name in KITTI_OFFLINE:
            # the offline chain's mode (int8 codes on), port_bench's bytes
            bnd = bound(b * h * w * (cin + cout) + wq.numel() + 12 * cout,
                        2 * b * h * w * cin * cout * k * k, "int8")
            ms = device_ms(lambda: kq.qconv_int8(x, wq, scale, bias, osc),
                           launches=5)
            kitti[name] = {"variant": variant, "plan": row["plan"],
                           "kernel_ms": ms, "bound_ms": bnd[0],
                           "bound_by": bnd[1],
                           "roofline_share_pct": 100.0 * bnd[0] / ms}
            continue
        if name not in TURBO_LAUNCHES:
            continue
        # the mode the model runs this layer in; int8 in, weights, three
        # float vectors, the output; two int8 operations per multiply-add
        mode = "f32" if cout <= 4 else "int8"
        kw, out_bytes = modes[mode], 4 if mode == "f32" else 1
        args = (x, wq, scale, bias)
        bnd = bound(b * h * w * (cin + cout * out_bytes) + wq.numel()
                    + 12 * cout, 2 * b * h * w * cin * cout * k * k, "int8")
        layers[name] = {
            "variant": variant, "mode": mode,
            "kernel_ms": device_ms(lambda: kq.qconv_int8(*args, **kw)),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "library_bf16_conv_ms": conv_library_ms(args),
            "launches_per_call": TURBO_LAUNCHES[name]}
        if k == 1 and cin % 8 == 0 and cout % 8 == 0:
            layers[name].update(int_mm_library(args))
        if name == "turbo_conv3_2":
            # the row of the kernels line: the kernel's and the library
            # call's device time, the plain version's event time
            row2 = (err, (layers[name]["kernel_ms"], median_ms(
                lambda: kq.qconv_reference(*args, **kw), 10)), bnd,
                layers[name]["library_bf16_conv_ms"])
            layers[name]["kernel_event_ms"] = median_ms(
                lambda: kq.qconv_int8(*args, **kw), 50)
    emit({"phase": "qconv_kernel", "results": results, "max_abs_err": err})
    emit({"phase": "qconv_kitti_offline", "batch": 64,
          "timing": "device time: 5 launches replayed as a CUDA graph "
                    "between one pair of events, median of 5",
          "layers": kitti})
    per_call = {key: sum(v[key] * v["launches_per_call"]
                         for v in layers.values())
                for key in ("kernel_ms", "bound_ms", "library_bf16_conv_ms")}
    mm = {n: v for n, v in layers.items() if "library_int_mm_ms" in v}
    per_call["int_mm_layers"] = {
        key: sum(v[key] * v["launches_per_call"] for v in mm.values())
        for key in ("kernel_ms", "library_int_mm_ms")}
    emit({"phase": "qconv_turbo_layers", "batch": 8,
          "timing": "device time: 20 launches replayed as a CUDA graph "
                    "between one pair of events, median of 5",
          "layers": layers, "per_device_call_14_launches": per_call})
    if not all(v["int_mm_equal"] for v in mm.values()):
        raise AssertionError("torch._int_mm's accumulator differs from the "
                             "plain one")
    return (max(err, row2[0]),) + row2[1:]


def phase_requant():
    import torch

    from densebox_tpu_torch.ops.kernels import requant as kr

    rng = np.random.RandomState(6)
    shape = (8, 120, 160, 64)
    acc = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, shape)
                           .astype(np.int32)).cuda()
    scale, bias, osc = (torch.from_numpy(v.astype(np.float32)).cuda() for v in (
        rng.uniform(1e-6, 3e-6, 64), rng.uniform(-0.5, 0.5, 64),
        rng.uniform(20, 40, 64)))
    results, err, times = {}, 0.0, {}
    for mode, o in (("int8", osc), ("f32", None)):
        got = kr.requant_epilogue(acc, scale, bias, o)
        want = kr.requant_reference(acc, scale, bias, o)
        torch.cuda.synchronize()
        diff = float((got.double() - want.double()).abs().max())
        results[mode] = {"equal": bool(torch.equal(got, want)),
                         "max_abs_err": diff}
        err = max(err, diff)
        args = (acc, scale, bias, o)
        times[mode] = (median_ms(lambda: kr.requant_epilogue(*args), 50),
                       median_ms(lambda: kr.requant_reference(*args), 20))
    emit({"phase": "requant_kernel", "input": list(shape), "results": results,
          "max_abs_err": err,
          "median_ms": {f"{m}_B8": {"kernel": t[0], "plain": t[1]}
                        for m, t in times.items()}})
    if not all(r["equal"] for r in results.values()):
        raise AssertionError(f"requant kernel disagrees with its plain "
                             f"version: {results}")
    # every launch of a hybrid device call of the turbo model (B=8): the
    # accumulator of each conv in the mode the model runs the layer in, its
    # device time beside its bound (int32 in, int8 or f32 out, three float
    # vectors; five float operations an element), and their sums
    layers = {}
    for name, b, h, w, _, cout, _ in QCONV_CASES:
        if name not in TURBO_LAUNCHES:
            continue
        la = torch.from_numpy(rng.randint(-2 ** 20, 2 ** 20, (b, h, w, cout))
                              .astype(np.int32)).cuda()
        vecs = [torch.from_numpy(rng.uniform(lo, hi, cout).astype(np.float32))
                .cuda() for lo, hi in ((1e-6, 3e-6), (-0.5, 0.5), (20, 40))]
        f32_out = cout <= 4                      # the heads' conv2
        args = (la, vecs[0], vecs[1], None if f32_out else vecs[2])
        kw = dict(relu=not f32_out)
        if not torch.equal(kr.requant_epilogue(*args, **kw),
                           kr.requant_reference(*args, **kw)):
            raise AssertionError(f"requant kernel disagrees with its plain "
                                 f"version at {name}")
        bnd = bound(la.numel() * (4 + (4 if f32_out else 1)) + 12 * cout,
                    la.numel() * 5)
        layers[name] = {
            "shape": list(la.shape), "mode": "f32" if f32_out else "int8",
            "kernel_ms": device_ms(lambda: kr.requant_epilogue(*args, **kw)),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "launches_per_call": TURBO_LAUNCHES[name]}
    per_call = {key: sum(v[key] * v["launches_per_call"]
                         for v in layers.values())
                for key in ("kernel_ms", "bound_ms")}
    per_call["share_of_bound"] = per_call["bound_ms"] / per_call["kernel_ms"]
    emit({"phase": "requant_turbo_layers", "batch": 8,
          "timing": "device time: 20 launches replayed as a CUDA graph "
                    "between one pair of events, median of 5",
          "layers": layers, "per_hybrid_call_14_launches": per_call})
    # int32 in, int8 out, three float vectors; five float operations each
    return err, times["int8"], bound(acc.numel() * 5 + 12 * 64,
                                     acc.numel() * 5)


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


def neck_levels(b, seed):
    """The int8 neck's inputs at kitti's four scales of a 480 x 640 canvas,
    batch ``b``, on the card: f3 codes (256 channels) over the whole int8
    range, f4 (512 channels) mostly a ReLU's output with a few negatives."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.infer.detector import pyramid_shapes

    g = torch.Generator(device="cuda").manual_seed(seed)
    levels = []
    for h, w, _, _ in pyramid_shapes(480, 640, kitti_vehicle().infer.scales):
        f3 = torch.randint(-127, 128, (b, h // 4, w // 4, 256), generator=g,
                           device="cuda", dtype=torch.int8)
        f4 = torch.rand((b, h // 8, w // 8, 512), generator=g,
                        device="cuda") * 5.0
        f4 = torch.where(torch.rand(f4.shape, generator=g, device="cuda")
                         < 0.3, 0.0, f4) - 0.05
        levels.append((f3, f4))
    return levels


def phase_neck():
    """The int8 neck kernel against its plain version on the card, at
    kitti's four scales (B=8 and 64) and two output scales, a power of two
    (quotients on exact halves) and an arbitrary one; times of a call's four
    launches at B=8 (the main path's serve batch) and 64 (the offline one)
    beside the bound of their bytes."""
    import torch

    from densebox_tpu_torch.ops.kernels import neck as kneck

    s3 = torch.tensor(0.0173, device="cuda")
    scales = {"pow2": torch.tensor(2.0 ** -5, device="cuda"),
              "arbitrary": torch.tensor(0.0219, device="cuda")}
    results, err, times = {}, 0.0, {}
    for b in (8, 64):
        levels = neck_levels(b, seed=b)
        for key, so in scales.items():
            for f3, f4 in levels:
                got = kneck.int8_neck(f3, f4, s3, so)
                want = kneck.neck_reference(f3, f4, s3, so)
                n_diff = int((got != want).sum())
                err = max(err, float((got.int() - want.int()).abs().max()))
                row = results.setdefault(f"B{b}_{key}", {
                    "shapes": [], "codes": 0, "codes_differing": 0})
                row["shapes"].append(list(got.shape))
                row["codes"] += got.numel()
                row["codes_differing"] += n_diff
                del got, want
        so = scales["arbitrary"]

        def kernel():
            return [kneck.int8_neck(f3, f4, s3, so) for f3, f4 in levels]

        def plain():
            return [kneck.neck_reference(f3, f4, s3, so) for f3, f4 in levels]

        # f3 codes and f4 in float32 read, 256 + 512 codes written a
        # position; per code written at most eight float operations (the
        # upsample's two products and sum in each direction, the quantise)
        n_out = sum(f3.numel() * 3 for f3, _ in levels)
        nbytes = sum(f3.numel() * 4 + f4.numel() * 4 for f3, f4 in levels)
        bnd = bound(nbytes, n_out * 8)
        dev = device_ms(kernel, 20 if b == 8 else 3)
        times[b] = {"kernel_ms": median_ms(kernel, 20),
                    "plain_ms": median_ms(plain, 5), "device_ms": dev,
                    "device_ms_per_image": dev / b, "bytes": nbytes,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "share_of_bound": bnd[0] / dev}
        del levels
        torch.cuda.empty_cache()
    emit({"phase": "neck_kernel", "canvas": [480, 640],
          "channels": [256, 512], "results": results, "max_abs_err": err,
          "timing": "kernel_ms, plain_ms: CUDA events around one call of "
                    "the four scales, median; device_ms: the call replayed "
                    "in a CUDA graph (20 calls at B=8, 3 at B=64) between "
                    "one pair of events, median of 5",
          "calls": {f"B{b}": t for b, t in times.items()}})
    if any(r["codes_differing"] for r in results.values()):
        raise AssertionError(f"int8 neck kernel disagrees with its plain "
                             f"version: {results}")
    t8, t64 = times[8], times[64]
    return err, (t8["kernel_ms"], t8["plain_ms"]), (
        t8["bound_ms"], t8["bound_by"]), None, {
        "shape_timed": "kitti's 4 scales of 480x640, B=8, a call",
        "device_ms": t8["device_ms"],
        "share_of_bound": t8["share_of_bound"],
        "B64": {k: t64[k] for k in ("kernel_ms", "plain_ms", "device_ms",
                                    "bound_ms", "share_of_bound")}}


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


def empty_launch_ms(grid_x: int, grid_y: int, block: int) -> float:
    """Device time of an empty kernel of that grid and block
    (csrc/floor.cu), read as ``device_ms`` reads a kernel: what the launch
    alone costs before any work."""
    import ctypes

    import torch

    from densebox_tpu_torch.ops.kernels import build

    fn = build.load("floor").densebox_empty_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        rc = fn(grid_x, grid_y, block, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty launch failed with CUDA error {rc}")

    return device_ms(launch)


# (case, B, S, L, Hm, Wm, D, win, shared origins): the MALF serve shape (the
# 5-scale pyramid of a 480x640 canvas; scale 1.4142 gives the largest map,
# 170x228), the bench's lm4 shape (one scale, 120x160, anchor-less), a
# ragged one (34- and 68-byte rows: the element kernel) and a short window
# (16-byte rows in bf16: one vector a row)
WINDOW_CASES = [("malf", 8, 5, 5, 170, 228, 64, 32, False),
                ("lm4", 8, 1, 4, 120, 160, 64, 32, True),
                ("ragged", 3, 2, 3, 37, 29, 5, 17, False),
                ("short", 2, 2, 3, 21, 27, 9, 8, True)]


def window_inputs(rng, b, s, num_lm, hm, wm, d, win, shared, dtype):
    import torch

    maps = torch.from_numpy(rng.standard_normal((b, s, num_lm, hm, wm))
                            .astype(np.float32)).cuda().to(dtype)
    lo = 1 if shared else num_lm
    idx = [rng.randint(0, s, (b, d)), rng.randint(0, hm - win + 1, (b, d, lo)),
           rng.randint(0, wm - win + 1, (b, d, lo))]
    return [maps] + [torch.from_numpy(a.astype(np.int32)).cuda() for a in idx]


def window_edge_inputs(rng, win, shared, dtype):
    """Windows on every edge of an odd-sized map, at every column offset
    modulo 8 from both sides (every byte shift of the realigned copy, odd
    and even), and maps that start one element into their storage (the
    source off a 16-byte boundary even at column 0)."""
    import torch

    b, s, num_lm, hm, wm = 2, 2, 3, 45, 53
    flat = torch.from_numpy(rng.standard_normal(b * s * num_lm * hm * wm + 1)
                            .astype(np.float32)).cuda().to(dtype)
    maps = flat[1:].view(b, s, num_lm, hm, wm)
    xs = list(range(8)) + [wm - win - k for k in range(8)]
    ys = [0, hm - win, 1, hm - win - 1]
    d = len(xs) * len(ys)
    lo = 1 if shared else num_lm
    y0 = np.repeat(ys, len(xs))[None, :, None] + np.zeros((b, d, lo), int)
    x0 = np.tile(xs, len(ys))[None, :, None] + np.zeros((b, d, lo), int)
    if not shared:                     # another offset per landmark channel
        x0 = (x0 + np.arange(lo)) % (wm - win + 1)
    sel = rng.randint(0, s, (b, d))
    return [maps] + [torch.from_numpy(a.astype(np.int32)).cuda()
                     for a in (sel, y0, x0)]


def phase_window():
    import torch

    from densebox_tpu_torch.ops.kernels import window as kw

    rng = np.random.RandomState(13)
    results, timed = [], {}

    def check(name, shape, shared, dtype, inputs, win):
        got = kw.gather_windows(*inputs, win)
        path = kw.last_path
        want = kw.gather_windows_reference(*inputs, win)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        same = bool(torch.equal(got.view(bits), want.view(bits)))
        dt = str(dtype).split(".")[-1]
        rows = (win * inputs[0].element_size()) % 16 == 0
        results.append({"case": name, "shape": shape, "shared": shared,
                        "dtype": dt, "bitwise_equal": same, "kernel": path,
                        "max_abs_err": float((got.float() - want.float())
                                             .abs().max())})
        if not same or path != ("rows" if rows else "elements"):
            emit({"phase": "window_kernel", "results": results})
            raise AssertionError(f"window kernel disagrees with its plain "
                                 f"version or took the other copy "
                                 f"({name}, {dt}, {path})")

    for name, *shape, shared in WINDOW_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            inputs = window_inputs(rng, *shape, shared, dtype)
            check(name, shape, shared, dtype, inputs, shape[-1])
            if name in ("malf", "lm4"):
                timed[name, dtype] = inputs + [shape[-1]]
    for win in (8, 17, 32):
        for shared in (False, True):
            for dtype in (torch.bfloat16, torch.float32):
                check("edges", [2, 2, 3, 45, 53, 64, win], shared, dtype,
                      window_edge_inputs(rng, win, shared, dtype), win)
    # origins from win before the map to win past it: both kernels move them
    # into the map as the plain version does
    for win in (8, 17):
        for dtype in (torch.bfloat16, torch.float32):
            shape = [2, 2, 3, 37, 45, 50, win]
            inputs = window_inputs(rng, *shape, False, dtype)
            for k, size in ((2, 37), (3, 45)):
                inputs[k] = torch.from_numpy(
                    rng.randint(-win, size + 1, (2, 50, 3)).astype(np.int32)
                ).cuda()
            check("outside", shape, False, dtype, inputs, win)
    args = timed["malf", torch.bfloat16]
    times = (device_ms(lambda: kw.gather_windows(*args)),
             median_ms(lambda: kw.gather_windows_reference(*args), 20))
    # the library call: one torch.take of the flat maps at an index of
    # every window element, built beforehand
    maps, sel, y0, x0, win = args
    _, n_s, n_l, hm, wm = maps.shape
    ar = torch.arange(win, device="cuda")
    rows = (y0.long().clamp(0, hm - win)[..., None] + ar)[..., :, None]
    cols = (x0.long().clamp(0, wm - win)[..., None] + ar)[..., None, :]
    plane = ((torch.arange(maps.shape[0], device="cuda")[:, None, None]
              * n_s + sel.long()[:, :, None]) * n_l
             + torch.arange(n_l, device="cuda"))[..., None, None]
    flat = (plane * hm + rows) * wm + cols
    if not torch.equal(torch.take(maps, flat), kw.gather_windows(*args)):
        raise AssertionError("window library call differs from the kernel")
    library_ms = device_ms(lambda: torch.take(maps, flat))
    device = {f"{n}_{str(dt).split('.')[-1]}":
              device_ms(lambda: kw.gather_windows(*a))
              for (n, dt), a in timed.items()}
    err = max(r["max_abs_err"] for r in results)
    # the windows read and written (bf16) and the int32 indices
    _, b, _, num_lm, _, _, d, win, _ = WINDOW_CASES[0]
    bnd = bound(2 * b * d * num_lm * win * win * 2
                + b * d * (1 + 2 * num_lm) * 4, 0)
    floor_ms = empty_launch_ms(b * d, 1, 256)
    emit({"phase": "window_kernel", "results": results, "max_abs_err": err,
          "device_ms": device,
          "event_ms_malf_bf16": {
              "kernel": median_ms(lambda: kw.gather_windows(*args), 50),
              "plain": times[1]},
          "bound_ms_malf_bf16": bnd[0],
          "library_ms_malf_bf16": library_ms,
          "library_call": "torch.take(maps, index) with a prebuilt index",
          "empty_launch_ms_grid512_block256": floor_ms})
    return err, times, bnd, library_ms, {"floor_ms": floor_ms}


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
        raise AssertionError("phase 14 decoded no detection or no landmark")
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


# --- the train step (phases 17-21) -----------------------------------------

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): the
# yardsticks of `bound_ms`
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str = "f32"):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the peak rate
    of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


LM_R2 = (0.0, 0.25, 1.0, 2.25, 6.25)     # squared radii of the edge cases


def label_rows(rng, b, k, m, num_lm, quarter=False):
    """Packed rasterizer rows: box rows (B, K, 8) = [cx, cy, rc2, rg2, x1,
    y1, x2, y2] and landmark rows (B, K*L, 3) = [lx, ly, r2], float32. Half
    the centres and radii are integers, so that pixels lie exactly on a
    disc's rim (d2 == rc2); a quarter of the slots are never positive (out
    of band), an eighth never gray either (invalid); patch 0 is empty; patch
    1 holds two boxes with one centre and two whose centres are equidistant
    from a column of pixels. With ``quarter`` every centre and radius lies
    on the quarter-pixel grid (rims everywhere) and the landmarks' squared
    radii come from ``LM_R2``."""
    c = rng.uniform(0, m, (b, k, 2))
    r = rng.uniform(0.5, m / 4, (b, k))
    integer = rng.rand(b, k) < 0.5
    c = np.where(integer[..., None], np.round(c), c)
    r = np.where(integer, np.maximum(np.round(r), 1), r)
    if quarter:
        c, r = np.round(c * 4) / 4, np.maximum(np.round(r * 4) / 4, 0.25)
    kind = rng.rand(b, k)
    rc2 = np.where(kind < 0.25, -1.0, r * r)
    rg2 = np.where(kind < 0.125, -1.0, (r + 2) ** 2)
    half = rng.uniform(1, m / 3, (b, k, 2))
    rows = np.stack([c[..., 0], c[..., 1], rc2, rg2,
                     c[..., 0] - half[..., 0], c[..., 1] - half[..., 1],
                     c[..., 0] + half[..., 0], c[..., 1] + half[..., 1]], -1)
    rows[0, :, 2:4] = -1.0
    if b > 1 and k >= 4:
        rows[1, 0, :4] = [m // 2, m // 2, 9.0, 25.0]
        rows[1, 1, :4] = rows[1, 0, :4]
        rows[1, 2, :4] = [2.0, 3.0, 16.0, 36.0]
        rows[1, 3, :4] = [6.0, 3.0, 16.0, 36.0]
    n = k * num_lm
    r2 = (rng.choice(LM_R2, (b, n, 1)) if quarter else np.ones((b, n, 1)))
    lm = np.concatenate([rng.uniform(-2, m + 2, (b, n, 2)),
                         np.where(rng.rand(b, n, 1) < 0.3, -1.0, r2)], -1)
    lm[:, ::2, :2] = np.round(lm[:, ::2, :2])      # rim-exact: d2 == 1
    if quarter:
        lm[..., :2] = np.round(lm[..., :2] * 4) / 4
    return rows.astype(np.float32), lm.astype(np.float32)


def landmark_edge_rows(m, num_lm, k, chunk):
    """Landmark rows (B, K*L, 3) that put a centre at every quarter pixel
    from 3 above to 3 below each map row where a block's chunk of ``chunk``
    output floats ends, at columns inside, on the rim of and outside the
    map, with every squared radius of ``LM_R2``."""
    row_len = m * num_lm
    edges = sorted({e // row_len for e in range(chunk, m * row_len, chunk)}
                   | {0, m - 1})
    xs = (-2.0, -0.25, 0.0, 0.25, m / 2 + 0.5, m - 1.0, m - 0.75, m + 2.0)
    rows = [(x, e + q / 4, r2) for e in edges for q in range(-12, 13)
            for r2 in LM_R2 for x in xs]
    per = k * num_lm
    b = -(-len(rows) // per)
    out = np.full((b * per, 3), -1.0, np.float32)
    out[:len(rows)] = rows
    return out.reshape(b, per, 3)


def bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


# (case, B, K, M, L): the training shape, a ragged one, the training shape
# on the quarter-pixel grid, with every slot invalid, and maps whose size is
# no multiple of 4 with as many rows as a patch may have (K = 1024 boxes:
# four staging passes; K * L = 1024 landmark rows)
RASTER_CASES = [("train", 32, 16, 60, 5), ("ragged", 3, 1, 8, 1),
                ("quarter_grid", 32, 16, 60, 5), ("all_invalid", 32, 16, 60, 5),
                ("m125_k1024", 2, 1024, 125, 1), ("m125_kl1024", 2, 256, 125, 4)]


def phase_rasterizers():
    """Phase 17: both rasterizer kernels, each alone and the two in one
    launch, against their plain versions on the card, bitwise, and the whole
    ``rasterize`` on the card against the CPU."""
    import torch

    from densebox_tpu_torch import LabelCfg
    from densebox_tpu_torch.ops.kernels import labels as kl
    from densebox_tpu_torch.ops.labels import rasterize

    rng = np.random.RandomState(17)
    inv = float(np.float32(1.0 / LabelCfg().loc_norm))
    names = ("score", "loc", "ignore", "lm")
    results, full = [], None

    def check(case, rows, lm_rows, m, num_lm):
        got = kl.rasterize_boxes(rows, m, inv) + (
            kl.rasterize_landmarks(lm_rows, m, num_lm),)
        both = kl.rasterize_maps(rows, lm_rows, m, inv, num_lm)
        want = kl.rasterize_boxes_reference(rows, m, inv) + (
            kl.rasterize_landmarks_reference(lm_rows, m, num_lm),)
        torch.cuda.synchronize()
        same = {n: bits_equal(g, w) for n, g, w in zip(names, got, want)}
        same_both = {n: bits_equal(g, w) for n, g, w in zip(names, both, want)}
        results.append({"case": case,
                        "shape": [rows.shape[0], rows.shape[1], m, num_lm],
                        "bitwise_equal": same,
                        "one_launch_bitwise_equal": same_both,
                        "positives": int(got[0].sum()),
                        "gray": int(got[2].sum()), "lm_pixels": int(got[3].sum()),
                        "max_abs_err": max(float((g - w).abs().max())
                                           for g, w in zip(got + both,
                                                           want + want))})
        if not all(same.values()) or not all(same_both.values()):
            emit({"phase": "rasterizer_kernels", "results": results})
            raise AssertionError(f"a rasterizer kernel disagrees with its "
                                 f"plain version: {results[-1]}")
        return got

    for case, b, k, m, num_lm in RASTER_CASES:
        rows, lm_rows = label_rows(rng, b, k, m, num_lm,
                                   quarter=case == "quarter_grid")
        if case == "all_invalid":
            rows[..., 2:4] = -1.0
            lm_rows[..., 2] = -1.0
        rows, lm_rows = torch.from_numpy(rows).cuda(), torch.from_numpy(lm_rows).cuda()
        got = check(case, rows, lm_rows, m, num_lm)
        if case == "train":
            full = (rows, lm_rows, m, num_lm)
            if not got[0].sum() > 0 or not got[3].sum() > 0:
                raise AssertionError("the training-shape case drew no "
                                     "positive pixel")
        if case == "all_invalid" and any(float(g.abs().sum()) for g in got):
            raise AssertionError("all-invalid rows gave a non-zero map")
    # landmark centres at every quarter pixel across the chunks' edges
    b, k, m, num_lm = RASTER_CASES[0][1:]
    chunk, chunks = kl.landmark_chunk(m, num_lm, b)
    edge = torch.from_numpy(landmark_edge_rows(m, num_lm, k, chunk)).cuda()
    box_rows = torch.from_numpy(label_rows(rng, len(edge), k, m, num_lm,
                                           quarter=True)[0]).cuda()
    check("landmarks_on_chunk_edges", box_rows, edge, m, num_lm)
    # px boxes through pack + kernels on the card against the CPU
    cfg = LabelCfg()
    bx = rng.uniform(20, 220, (32, 16, 2))
    h = rng.uniform(25, 80, (32, 16))
    w = h * rng.uniform(0.7, 1.3, (32, 16))
    boxes = torch.from_numpy(np.concatenate(
        [bx - np.stack([w, h], -1) / 2, bx + np.stack([w, h], -1) / 2],
        -1).astype(np.float32))
    valid = torch.from_numpy(rng.rand(32, 16) > 0.5)
    lms = torch.from_numpy((bx[:, :, None] + rng.uniform(-20, 20, (32, 16, 5, 2))
                            ).astype(np.float32))
    lmv = torch.from_numpy(rng.rand(32, 16, 5) > 0.2)
    on_card = rasterize(boxes.cuda(), valid.cuda(), cfg, lms.cuda(), lmv.cuda())
    on_cpu = rasterize(boxes, valid, cfg, lms, lmv)
    same = {n: bits_equal(on_card[n].cpu(), on_cpu[n]) for n in on_cpu}
    results.append({"case": "px_boxes_card_vs_cpu", "shape": [32, 16, 60, 5],
                    "bitwise_equal": same,
                    "positives": int(on_cpu["score"].sum())})
    rows, lm_rows, m, num_lm = full
    calls = {
        "rasterize_boxes": lambda: kl.rasterize_boxes(rows, m, inv),
        "rasterize_landmarks": lambda: kl.rasterize_landmarks(lm_rows, m,
                                                              num_lm),
        "rasterize_maps": lambda: kl.rasterize_maps(rows, lm_rows, m, inv,
                                                    num_lm)}
    times = {
        "rasterize_boxes": (
            median_ms(calls["rasterize_boxes"], 50),
            median_ms(lambda: kl.rasterize_boxes_reference(rows, m, inv), 7)),
        "rasterize_landmarks": (
            median_ms(calls["rasterize_landmarks"], 50),
            median_ms(lambda: kl.rasterize_landmarks_reference(
                lm_rows, m, num_lm), 7))}
    err = max(r.get("max_abs_err", 0.0) for r in results)
    b, k = rows.shape[:2]
    device = {n: device_ms(fn) for n, fn in calls.items()}
    # an empty kernel of each rasterizer's grid and block (csrc/labels.cu:
    # 256 threads; boxes: tiles of 32 x 8 pixels, batch in y; landmarks:
    # the chunks of a patch's output, batch in y; both maps: the wider of
    # the two grids twice)
    box_blocks = -(-m // 32) * -(-m // 8)
    floors = {
        "rasterize_boxes": empty_launch_ms(box_blocks, b, 256),
        "rasterize_landmarks": empty_launch_ms(chunks, b, 256),
        "rasterize_maps": empty_launch_ms(2 * max(box_blocks, chunks), b, 256)}

    def both_launches():
        calls["rasterize_boxes"]()
        calls["rasterize_landmarks"]()

    # what a malf step pays for its two maps: two launches, or one
    two_maps = {"two_launches": {"device_ms": device_ms(both_launches),
                                 "event_ms": median_ms(both_launches, 50)},
                "one_launch": {"device_ms": device["rasterize_maps"],
                               "event_ms": median_ms(calls["rasterize_maps"],
                                                     50)}}
    emit({"phase": "rasterizer_kernels", "results": results,
          "max_abs_err": err,
          "median_ms": {n: {"kernel": t[0], "plain": t[1]}
                        for n, t in times.items()},
          "device_ms": device, "empty_launch_ms_same_grid": floors,
          "grids": {"rasterize_boxes": [box_blocks, b],
                    "rasterize_landmarks": [chunks, b],
                    "landmark_chunk_floats": chunk},
          "two_maps": two_maps})
    if not all(same.values()):
        raise AssertionError(f"rasterize on the card differs from the CPU: "
                             f"{same}")
    # what this run's rows need: the box kernel tests every pixel against
    # the rows that can be positive or gray (12 operations each); the
    # landmark kernel the pixels within a disc's reach for each row with
    # r2 >= 0 (7 operations each); both write every output once
    live = int(((rows[..., 2] >= 0) | (rows[..., 3] >= 0)).sum())
    lm_live = lm_rows[lm_rows[..., 2] >= 0]
    lm_tests = float(((2 * lm_live[:, 2].sqrt().ceil() + 1) ** 2).sum())
    bounds = {
        "rasterize_boxes": bound(rows.numel() * 4 + b * m * m * 6 * 4,
                                 live * m * m * 12),
        "rasterize_landmarks": bound(lm_rows.numel() * 4
                                     + b * m * m * num_lm * 4, lm_tests * 7)}
    times = {n: (device[n], t[1]) for n, t in times.items()}
    return err, times, bounds, {n: floors[n] for n in times}


def ohem_case(rng, b, p, kind):
    """(sq, pos, ign, rnd) inputs of ``ohem_select``: 'random' errors with
    positives and a gray zone; 'tied' (all errors equal: the noise alone
    orders the hard half); 'no_pos' (min_neg applies); 'short' (fewer
    candidates than the quota)."""
    sq = rng.uniform(0, 2, (b, p)).astype(np.float32) ** 2
    pos = rng.rand(b, p) < 0.03
    ign = (rng.rand(b, p) < 0.05) & ~pos
    if kind == "tied":
        sq[:] = 0.25
    elif kind == "no_pos":
        pos[:] = False
    elif kind == "short":
        pos = rng.rand(b, p) < 0.6
        ign = ~pos & (rng.rand(b, p) < 0.9)
    return sq, pos, ign, rng.rand(b, p).astype(np.float32)


def ohem_forward_case(b):
    """``ohem_select`` inputs from a real forward: the squared errors of the
    paper model's score map on a synthetic batch of ``b`` patches (P=3600),
    its positives and gray zone, and uniforms drawn on the card."""
    import torch

    from densebox_tpu_torch import kitti_vehicle
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.ops.labels import rasterize

    cfg = kitti_vehicle()
    gen = torch.Generator(device="cuda").manual_seed(18)
    batch = synthetic_batch(gen, b, cfg.label, cfg.train.max_boxes)
    gts = rasterize(batch["boxes"], batch["box_valid"], cfg.label)
    with torch.inference_mode():
        score = init_model(cfg.model, "cuda")(batch["image"])["score"]
    p = score[0].numel()
    return [((score - gts["score"]) ** 2).reshape(b, p).contiguous(),
            (gts["score"] > 0.5).reshape(b, p), (gts["ignore"] > 0.5).reshape(b, p),
            torch.rand((b, p), device="cuda", generator=gen)]


def ohem_edge_case(rng, p):
    """One sample per row whose candidate set is empty, one pixel, as large
    as the quota (min_neg = 16: n_hard = n_rand = 8, so 8 and 9 bracket the
    hard quota and 16 and 17 the whole), around the 256 elements one warp
    finishes on, and all but one pixel; no positives, half the rows with
    tied errors."""
    sizes = [0, 1, 8, 9, 16, 17, 255, 256, 257, 300, p - 1, p]
    b = 2 * len(sizes)
    sq = rng.uniform(0, 2, (b, p)).astype(np.float32) ** 2
    sq[len(sizes):] = np.round(sq[len(sizes):] * 2) / 2
    ign = np.ones((b, p), bool)
    for i, n in enumerate(sizes * 2):
        ign[i, rng.permutation(p)[:n]] = False
    return sq, np.zeros((b, p), bool), ign, rng.rand(b, p).astype(np.float32)


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


def phase_ohem():
    """Phase 18: the OHEM kernel against its plain version on the card,
    bitwise, at B=32, P=3600 and on the edge sets; device times of the
    kernel, of two launches against one stacked launch, and of its
    floors."""
    import ctypes

    import torch

    from densebox_tpu_torch.ops.kernels import build
    from densebox_tpu_torch.ops.kernels import ohem as ko

    rng = np.random.RandomState(18)
    b, p = 32, 3600
    cases = {kind: [torch.from_numpy(a).cuda()
                    for a in ohem_case(rng, b, p, kind)]
             for kind in ("random", "tied", "no_pos", "short")}
    cases["forward"] = ohem_forward_case(b)
    cases["edge_sets"] = [torch.from_numpy(a).cuda()
                          for a in ohem_edge_case(rng, p)]
    results = []
    for kind, args in cases.items():
        want = ko.ohem_select_reference(*args, 1.0, 0.5, 16)
        got = ko.ohem_select(*args, 1.0, 0.5, 16)
        torch.cuda.synchronize()
        results.append({"case": kind, "shape": list(args[0].shape),
                        "positives": int(args[1].sum()),
                        "sampled": int(want.sum()),
                        "mismatches": int((got != want).sum())})
        if results[-1]["mismatches"] or not want.any():
            emit({"phase": "ohem_kernel", "results": results})
            raise AssertionError(f"OHEM kernel disagrees with its plain "
                                 f"version ({kind})")
    args = cases["forward"]
    times = (device_ms(lambda: ko.ohem_select(*args, 1.0, 0.5, 16)),
             median_ms(lambda: ko.ohem_select_reference(*args, 1.0, 0.5, 16), 5))
    # a malf step's two terms (score and refined: other errors and uniforms,
    # the same flags): two launches, or one over the stacked terms
    sq2 = torch.rand_like(args[0]) ** 2
    rnd2 = torch.rand_like(args[3])

    def two_launches():
        ko.ohem_select(*args, 1.0, 0.5, 16)
        ko.ohem_select(sq2, args[1], args[2], rnd2, 1.0, 0.5, 16)

    def stacked():
        ko.ohem_select(torch.cat([args[0], sq2]), args[1].repeat(2, 1),
                       args[2].repeat(2, 1), torch.cat([args[3], rnd2]),
                       1.0, 0.5, 16)

    terms = {"two_launches": {"device_ms": device_ms(two_launches),
                              "event_ms": median_ms(two_launches, 50)},
             "one_stacked_launch": {"device_ms": device_ms(stacked),
                                    "event_ms": median_ms(stacked, 50)}}
    # floors: an empty kernel of the kernel's grid and block, and a chain of
    # dependent block-wide rounds through the kernel's reducer
    threads = build.load("ohem").densebox_ohem_block_threads(p)
    chain_fn = build.load("floor").densebox_round_chain
    chain_fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    chain_fn.restype = ctypes.c_int
    scratch = torch.empty(b, dtype=torch.int32, device="cuda")

    def chain(rounds):
        def launch():
            rc = chain_fn(scratch.data_ptr(), b, threads, rounds,
                          torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"round chain failed with CUDA error {rc}")
        return device_ms(launch)

    round_us = (chain(200) - chain(0)) / 200 * 1e3
    schedule = {kind: ohem_chain(cases[kind]) for kind in ("forward", "tied")}
    floor_ms = empty_launch_ms(b, 1, threads)
    bnd = bound(b * p * 11, b * p * 3 * 40 * 2)
    emit({"phase": "ohem_kernel", "results": results, "max_abs_err": 0.0,
          "device_ms": {"forward_B32_P3600": times[0],
                        "tied_B32_P3600": device_ms(
                            lambda: ko.ohem_select(*cases["tied"], 1.0, 0.5, 16))},
          "event_ms": {"kernel": median_ms(
              lambda: ko.ohem_select(*args, 1.0, 0.5, 16), 50),
              "plain": times[1]},
          "block_threads": threads,
          "two_terms": terms, "bound_ms": bnd[0],
          "empty_launch_ms_same_grid": floor_ms,
          "block_round_us": round_us,
          "schedule_worst_sample": schedule,
          # the launch and the block-wide rounds of the schedule's model; the
          # warp's levels are not in it
          "block_rounds_floor_ms_forward": (
              floor_ms + schedule["forward"]["block_rounds"] * round_us * 1e-3)})
    # 10 bytes read and 1 written per pixel; three 40-step bisections, each
    # step one compare and one add per pixel
    return 0.0, times, bnd, None, {"floor_ms": floor_ms}


def train_cfgs():
    """(name, config) of the two train cells: the presets at full width in
    f32, as published (B=32, 240 px patches, K=16)."""
    from densebox_tpu_torch import kitti_vehicle, malf_face

    return [("kitti_vehicle", kitti_vehicle()), ("malf_face", malf_face())]


def phase_step_card_vs_cpu():
    """Phase 19: one train step on the card against the CPU, full width,
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
    """Phase 19, second part: the full-width step (B=32, f32; malf_face
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
    """Phases 20 and 21: train ``cfg`` at full width on synthetic batches
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
    """Phase 22: ``fit`` on kitti_vehicle() at full width, B=32, 240 px, on
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
    return launches


# --- the command line (phase 23) ------------------------------------------

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
    """Phase 23: the command line on the card, as a user runs it, on a
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


# --- multi-device (phase 24) and the 'xla' int8 chain (phase 25) ----------

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
    """Phase 24 (see the docstring). Returns the launches of the new paths
    by run, for the kernels line."""
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
    launches = {}
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
            launches["nccl_world1_step"] = read_launches()
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
              "ms_per_step_in_turns": turns,
              "bare_ms_phase20": bare_ms,
              "fit_use_mesh_ms_per_step": fit_ms,
              "fit_dp_ranks": dp_ranks,
              "fit_checkpoints": kept,
              "fit_last_metrics": res.last_metrics, "card": card_line()})
        if not same or not all(metrics_same.values()):
            raise AssertionError(f"one-rank NCCL step differs from the bare "
                                 f"step: state {same}, {metrics_same}")
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
            launches[f"{name}_step_rank0"] = ranks[0]["launches_step"]
            launches[f"spatial{world}_detect_rank0"] = \
                ranks[0]["launches_detect"]
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
    return launches


def phase_xla_int8():
    """Phase 25: the turbo_int8 cell (B=8, 480 x 640, one scale) with the
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
    return launches


# a process that loads an artifact with the JAX package and jax blocked and
# every model forward and detect_batch raising (phase 26)
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
    """The cells of phase 26 as (name, model config, infer and label
    configs, int8 chain or None, loc bias): turbo_int8 (the int8 serve
    cell), paper and malf_bf16 (the bf16 serve cells)."""
    (_, paper, p_infer, p_label), (_, turbo, t_infer, t_label) = \
        serving_cells()
    malf = landmark_cells()[0]
    return [("turbo_int8", turbo, t_infer, t_label, "fused", 0.0),
            ("paper", paper, p_infer, p_label, None, 0.0),
            (malf[0], *malf[1:4], None, 1.0)]


def phase_export():
    """Phase 26: the detect pipeline exported (``export.py``) at full width,
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
    from densebox_tpu_torch.models import densebox as mdb
    from densebox_tpu_torch.ops.kernels import qconv as kq

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="densebox_export_")
    proc = None
    counts = {}
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
                          mdb._interp_matrix):
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
            counts[f"export_{name}"] = art_launches
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
    return counts


# --- the reference's precision (phase 27), certification (phase 28) ------

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
    from densebox_tpu_torch.models.densebox import (_interp_matrix,
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
    """Phase 27: the port's precision under torch's own flags (see the
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
        raise AssertionError(f"precision flags {flags} at phase 27, not "
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
    """Phase 28: the certification tool on the card, one short row."""
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


# --- the port's bench and its serve load test (phase 29) -----------------

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
    """Phase 29: ``python -m densebox_tpu_torch.bench`` in this process
    through its ``main`` at the published presets and batches, one bench
    call of turbo int8 at B=256 held to ``detect_batch`` of its batch, and
    ``python -m densebox_tpu_torch.loadtest --turbo-int8`` at 1, 8, 16 and
    32 clients with every answer held to a detect of its image alone.
    Returns each run's kernel launches of one pass."""
    import torch

    from densebox_tpu_torch import bench, loadtest
    from densebox_tpu_torch.serve import DetectServer

    t_phase = time.perf_counter()
    counts = {}
    for name, argv in BENCH_RUNS:
        torch.cuda.empty_cache()
        out, err = run_main(bench.main, argv)
        line, info = json.loads(out[-1]), json.loads(err[-1])
        counts[f"bench_{name}"] = launches = info["launches_per_pass"]
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
    counts["loadtest"] = launches
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
    return counts


def cv2_version():
    """cv2's version where it imports, else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


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
    # precision itself (phase 27), and leaves the flags as it found them
    TORCH_DEFAULTS.update(precision_flags())

    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phase_build()
    # kernel name -> (max_abs_err, (ms, plain_ms), bound, library_ms, further
    # keys of its entry in the kernels line)
    rows = {}
    rows["nms"] = phase_nms()
    phase_forward()

    launches = {name: phase_serve(f"serve_{name}_bf16", *cfgs)
                for name, *cfgs in serving_cells()}
    rows["qconv"] = phase_qconv() + ({},)
    rows["requant"] = phase_requant() + (None, {})
    phase_forward_int8()
    rows["neck"] = phase_neck()
    _, turbo, turbo_infer, label = serving_cells()[1]
    for quant in ("fused", "hybrid"):
        launches[quant] = phase_serve(f"serve_turbo_int8_{quant}", turbo,
                                      turbo_infer, label, quant=quant)
    rows["window"] = phase_window()
    phase_decode_card_vs_cpu()
    for name, *cfgs, quant in landmark_cells():
        launches[name] = phase_serve(f"serve_{name}", *cfgs, quant=quant,
                                     loc_bias=1.0)

    l_err, l_times, l_bounds, l_floors = phase_rasterizers()
    for name in l_times:
        rows[name] = (l_err, l_times[name], l_bounds[name], None,
                      {"floor_ms": l_floors[name]})
    rows["ohem"] = phase_ohem()
    phase_step_card_vs_cpu()
    phase_step_repeats()
    (_, kitti), (_, malf) = train_cfgs()
    launches["train_kitti"], bare_ms = phase_train("kitti_vehicle", kitti, 30,
                                                   False)
    launches["train_malf"], _ = phase_train("malf_face", malf, 12, True)
    launches["fit"] = phase_fit()
    phase_cli(bare_ms)
    multi = phase_multi_device(bare_ms)
    multi["xla_int8_call"] = phase_xla_int8()
    multi.update(phase_export())
    phase_precision(bare_ms)
    phase_certify()
    multi.update(phase_bench())

    # (name, source, TPU kernel it replaces (none for the int8 neck), the
    # main-path run its launch count is read from, its counter)
    table = [
        ("greedy_nms_keep", "nms", "nms.py:28", "paper", "nms"),
        ("qconv_int8", "qconv", "qconv.py:59", "fused", "qconv"),
        ("requant_epilogue", "requant", "requant.py:35", "hybrid", "requant"),
        ("gather_windows", "window", "window.py:53", "malf_bf16", "window"),
        ("rasterize_boxes", "labels", "labels.py:46", "train_kitti",
         "rasterize_boxes"),
        ("rasterize_landmarks", "labels", "labels.py:79", "train_malf",
         "rasterize_landmarks"),
        ("ohem_select", "ohem", "ohem.py:53", "train_kitti", "ohem"),
        ("int8_neck", "neck", None, "fused", "neck")]
    flags = precision_flags()
    emit({"phase": "precision_flags_at_end", "flags": flags,
          "torch_defaults": TORCH_DEFAULTS})
    if flags != TORCH_DEFAULTS:
        raise AssertionError(f"the precision flags end as {flags}, not as "
                             f"torch started: {TORCH_DEFAULTS}")
    print(card, flush=True)
    kernels = []
    for name, src, replaces, run, counter in table:
        (err, (ms, plain_ms), (bound_ms, bound_by), library_ms,
         more) = rows[counter]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"densebox_tpu_torch/csrc/{src}.cu",
            "replaces": (f"densebox_tpu/ops/pallas/{replaces}" if replaces
                         else "none: XLA fused these steps"),
            "launches": launches[run][counter], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **more,
            **{f"launches_{run_}": counts[counter]
               for run_, counts in multi.items()}})
    emit({"phase": "seconds", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
