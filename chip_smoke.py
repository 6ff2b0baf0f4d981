#!/usr/bin/env python3
"""Drive the PyTorch port's detect-and-serve paths once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises, so the exit code is
not 0):
  1. no card, no run: without CUDA the script exits 1 with no result;
  2. the card's name and power limit (nvidia-smi);
  3. build the CUDA kernels (NMS, int8 conv, requant, window gather) from
     densebox_tpu_torch/csrc, one nvcc per source, all at once;
  4. NMS kernel against its plain PyTorch version on the card (B=8,
     K in {256, 512, 1024}, random boxes and IoU-on-threshold pairs: keep
     masks, indices, boxes and scores identical), with median times;
  5. the paper model (width 1.0) forward in f32 on the card against the
     port on the CPU (TF32 off; 1e-3 absolute), then a bf16 forward;
  6. serve: a DetectServer with the paper model in bf16, 480x640 canvas,
     max_batch 8, the preset's 4-scale pyramid; 24 requests from 8 threads,
     answered, coalesced, and each equal to a direct detect_batch of the
     batch its device call ran;
  7. the same serve run with the turbo trunk (s2d4, depth 3, width 0.25);
  8. int8 conv kernel against its plain version on the card, in its three
     output modes, at the turbo model's layer shapes (B=8), paper shapes
     and ragged edges: outputs identical; median times at turbo conv3_2;
  9. requant kernel against its plain version (B=8, 120x160x64, int8 and
     f32 outputs): identical; median times;
 10. the paper model in int8, calibrated on the card: its forward on the
     card against the plain versions on the CPU with the same int8 state
     (B=2, 240x320): every int8 code and map identical; the fused and the
     hybrid chain identical on the card;
 11. serve the turbo model in int8 (calibrated on the card from the canvas
     batch, one scale), as phase 7: served equal to direct, one int8 conv
     launch per conv per device call, one NMS launch per device call;
 12. the same with the hybrid chain (int32 conv, then requant);
 13. window-gather kernel against its plain version on the card, bitwise:
     the MALF serve shape (B=8, S=5, L=5, 170x228, D=64, win 32, bf16 and
     f32, per-landmark origins), the bench's lm4 shape (B=8, S=1, L=4,
     120x160, shared origins) and a ragged one (win 17, odd map, D=5);
     median times at the first two;
 14. landmark decode, card against CPU: the malf_face() model (width 1.0,
     5 landmarks, refine) in bf16 runs its 5-scale pyramid once on the card
     (B=2, 240x320); everything after the forward (decode, cap, NMS, scale
     selection, landmark decode) then runs on those maps on the card and on
     the CPU: boxes, scores, validity and landmarks identical, and the
     'std' scale selection counted where it differs;
 15. serve malf_face() in bf16 (480x640 canvas, max_batch 8, its pyramid
     and anchors, lm_topk 64), as phase 6: served equal to a direct
     detect_batch bit for bit, landmarks included; one NMS and one window
     launch per device call;
 16. serve the bench's landmark pipeline in int8: the turbo trunk with 4
     landmarks and refine, no anchors (shared origins), calibrated on the
     card, one scale: as phase 15, plus one int8 conv launch per conv.
Each serve run resets every kernel's launch counter just before its
requests and reads them just after. The line before the last lists the
kernels, after the card line again; the last line is
{"ok": true, "device": {...}}.

Weights are random (torch.Generator seeds), so detections are not
meaningful objects: the score threshold of the serve phases is set from
the model's own score map (the refine branch's, where it has one) so that
candidates reach NMS, and the landmark phases give the loc head a bias of
one so that boxes span a few map pixels (near-zero random loc maps give
boxes of a pixel, whose landmarks all take the centre fallback).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = ("nms", "qconv", "requant", "window")     # csrc/<name>.cu


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
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
        times.append(start.elapsed_time(end))
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


def threshold_case(rng, b, k):
    """Pairs whose IoU is 0.5 in exact arithmetic: integer pairs where f32
    gives exactly 0.5 (kept), and float pairs shifted by a third of their
    width, which f32 rounds to either side of 0.5."""
    n = k // 2
    x = rng.uniform(0, 600, (b, n)).astype(np.float32)
    y = rng.uniform(0, 400, (b, n)).astype(np.float32)
    w = rng.uniform(6, 90, (b, n)).astype(np.float32)
    h = rng.uniform(6, 90, (b, n)).astype(np.float32)
    integer = rng.uniform(size=(b, n)) < 0.5
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
    times = {}
    for k in (256, 512):
        boxes, scores, valid = random_case(rng, 8, k)
        sb = torch.from_numpy(boxes).to(dev)
        sv = torch.from_numpy(valid).to(dev)
        times[k] = (median_ms(lambda: knms.greedy_keep(sb, sv, 0.5), 50),
                    median_ms(lambda: knms.greedy_keep_reference(sb, sv, 0.5), 7))
    emit({"phase": "nms_kernel", "results": results, "max_abs_err": err,
          "median_ms": {f"B8_K{k}": {"kernel": t[0], "plain": t[1]}
                        for k, t in times.items()}})
    return err, times[512]


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


def serving_cells():
    """The two serving configurations as (name, model, infer and label
    configs): the paper preset at full width with its 4-scale pyramid, and
    the turbo trunk at scale 1.0, both in bf16."""
    from densebox_tpu_torch import ModelCfg, kitti_vehicle

    preset = kitti_vehicle()
    paper = dataclasses.replace(preset.model, compute_dtype="bfloat16")
    turbo = ModelCfg(stem="s2d4", trunk_depth=3, width_mult=0.25,
                     compute_dtype="bfloat16")
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
                         num_landmarks=4, use_refine=True,
                         compute_dtype="bfloat16")
    return [("malf_bf16",
             dataclasses.replace(malf.model, compute_dtype="bfloat16"),
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
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
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


# (name, B, H, W, Cin, Cout, k): the turbo model's int8 convs at the serving
# batch (s2d4 conv1_1, conv3_2, conv4_2, head conv1 and loc conv2), paper
# conv1_1 and conv4_2 (B=2 keeps the plain version short), then ragged
# edges: W=33, H not a multiple of the 8-row tile, Cin=5
QCONV_CASES = [
    ("turbo_conv1_1", 8, 120, 160, 48, 16, 3),
    ("turbo_conv3_2", 8, 120, 160, 64, 64, 3),
    ("turbo_conv4_2", 8, 60, 80, 128, 128, 3),
    ("turbo_head_conv1", 8, 120, 160, 192, 128, 1),
    ("turbo_loc_conv2", 8, 120, 160, 128, 4, 1),
    ("paper_conv1_1", 2, 240, 320, 3, 64, 3),
    ("paper_conv4_2", 2, 30, 40, 512, 512, 3),
    ("ragged", 3, 13, 33, 5, 24, 3),
]


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
    results, err, timed = [], 0.0, None
    for name, *shape in QCONV_CASES:
        x, wq, scale, bias, osc = qconv_inputs(rng, *shape, "cuda")
        modes = {"int8": dict(out_scale=osc), "f32": dict(relu=False),
                 "int32": dict(out="int32")}
        row = {"case": name, "shape": shape}
        for mode, kw in modes.items():
            got = kq.qconv_int8(x, wq, scale, bias, **kw)
            want = kq.qconv_reference(x, wq, scale, bias, **kw)
            torch.cuda.synchronize()
            diff = float((got.double() - want.double()).abs().max())
            row[mode] = {"equal": bool(torch.equal(got, want)),
                         "max_abs_err": diff}
            err = max(err, diff)
            if not row[mode]["equal"]:
                emit({"phase": "qconv_kernel", "results": results + [row]})
                raise AssertionError(f"int8 conv kernel disagrees with its "
                                     f"plain version ({name}, {mode})")
        results.append(row)
        if name == "turbo_conv3_2":
            args = (x, wq, scale, bias, osc)
            timed = (median_ms(lambda: kq.qconv_int8(*args), 50),
                     median_ms(lambda: kq.qconv_reference(*args), 10))
    emit({"phase": "qconv_kernel", "results": results, "max_abs_err": err,
          "median_ms": {"turbo_conv3_2_int8_B8": {"kernel": timed[0],
                                                  "plain": timed[1]}}})
    return err, timed


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
    return err, times["int8"]


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
    cpu = QuantDenseBox(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    hybrid = QuantDenseBox(cfg, backend="hybrid", device="cuda").eval()
    hybrid.load_state_dict(gpu.state_dict())
    t0 = time.perf_counter()
    want, want_q = recorded_forward(cpu, x)
    cpu_s = time.perf_counter() - t0
    got, got_q = recorded_forward(gpu, x.cuda())
    hyb, _ = recorded_forward(hybrid, x.cuda())
    torch.cuda.synchronize()
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
          "cpu_plain_seconds": cpu_s})
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


def init_quant_model(cfg, calib, backend="fused", seed=0, loc_bias=0.0):
    """The int8 model of the float model ``init_model`` makes, calibrated
    on ``calib`` (on its device)."""
    from densebox_tpu_torch.models import QuantDenseBox, quantize_densebox

    sd = quantize_densebox(float_state(cfg, seed, loc_bias), cfg, calib)
    model = QuantDenseBox(cfg, backend=backend, device=calib.device)
    model.load_state_dict(sd)
    return model.eval()


# (case, B, S, L, Hm, Wm, D, win, shared origins): the MALF serve shape (the
# 5-scale pyramid of a 480x640 canvas; scale 1.4142 gives the largest map,
# 170x228), the bench's lm4 shape (one scale, 120x160, anchor-less) and a
# ragged one
WINDOW_CASES = [("malf", 8, 5, 5, 170, 228, 64, 32, False),
                ("lm4", 8, 1, 4, 120, 160, 64, 32, True),
                ("ragged", 3, 2, 3, 37, 29, 5, 17, False)]


def window_inputs(rng, b, s, num_lm, hm, wm, d, win, shared, dtype):
    import torch

    maps = torch.from_numpy(rng.standard_normal((b, s, num_lm, hm, wm))
                            .astype(np.float32)).cuda().to(dtype)
    lo = 1 if shared else num_lm
    idx = [rng.randint(0, s, (b, d)), rng.randint(0, hm - win + 1, (b, d, lo)),
           rng.randint(0, wm - win + 1, (b, d, lo))]
    return [maps] + [torch.from_numpy(a.astype(np.int32)).cuda() for a in idx]


def phase_window():
    import torch

    from densebox_tpu_torch.ops.kernels import window as kw

    rng = np.random.RandomState(13)
    results, times = [], {}
    for name, *shape, shared in WINDOW_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            maps, sel, y0, x0 = window_inputs(rng, *shape, shared, dtype)
            win = shape[-1]
            got = kw.gather_windows(maps, sel, y0, x0, win)
            want = kw.gather_windows_reference(maps, sel, y0, x0, win)
            torch.cuda.synchronize()
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = bool(torch.equal(got.view(bits), want.view(bits)))
            dt = str(dtype).split(".")[-1]
            results.append({"case": name, "shape": shape, "shared": shared,
                            "dtype": dt, "bitwise_equal": same,
                            "max_abs_err": float((got.float() - want.float())
                                                 .abs().max())})
            if not same:
                emit({"phase": "window_kernel", "results": results})
                raise AssertionError(f"window kernel disagrees with its plain "
                                     f"version ({name}, {dt})")
            if name != "ragged" and dtype == torch.bfloat16:
                args = (maps, sel, y0, x0, win)
                times[name] = (median_ms(lambda: kw.gather_windows(*args), 50),
                               median_ms(lambda: kw.gather_windows_reference(
                                   *args), 20))
    err = max(r["max_abs_err"] for r in results)
    emit({"phase": "window_kernel", "results": results, "max_abs_err": err,
          "median_ms": {f"{k}_bf16": {"kernel": t[0], "plain": t[1]}
                        for k, t in times.items()}})
    return err, times["malf"]


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


def kernel_modules():
    from densebox_tpu_torch.ops.kernels import nms, qconv, requant, window

    return {"nms": nms, "qconv": qconv, "requant": requant, "window": window}


def phase_serve(name, model_cfg, infer_cfg, label_cfg, quant=None,
                canvas_hw=(480, 640), n_req=24, n_threads=8, loc_bias=0.0):
    """Serve ``n_req`` requests from ``n_threads`` clients with the float
    model, or with ``quant`` ('fused' or 'hybrid') its int8 model calibrated
    on the first canvas batch. Returns the kernels' launch counts."""
    import torch

    from densebox_tpu_torch.infer import detect_batch
    from densebox_tpu_torch.models.quant import conv_names
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
    batches = []          # each device call's batch, as the card got it
    serve_detect = server._detect

    def recording(batch):
        batches.append(batch.clone())
        return serve_detect(batch)

    server._detect = recording
    results, lat = [None] * n_req, [None] * n_req
    kernels = kernel_modules()
    try:
        for mod in kernels.values():
            mod.reset_launches()
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
        launches = {k: mod.launches for k, mod in kernels.items()}
        stats = dict(server.stats)
    finally:
        server.close()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"{name}: not every request was answered")
    # Each request was served letterboxed (no downscale: no image is larger
    # than the canvas, so no change of coordinates) from one slot of one
    # device call. cuDNN's kernels for some convolution shapes make an
    # image's maps depend, in the last bit, on its slot in the batch (seen
    # on conv4_2 at odd map widths), so each served result is held to a
    # direct detect_batch of the very batch its call ran, bit for bit; its
    # slot is found by content. How many of the first 8 requests differ
    # from a detect of `canvas` (the same images in other slots) is printed.
    def detect(batch):
        with torch.inference_mode():
            out = {k: v.cpu().numpy() for k, v in detect_batch(
                model, batch, infer_cfg, label_cfg).items()}
        return [{k: v[s][out["valid"][s]] for k, v in out.items()
                 if k != "valid"} for s in range(len(batch))]

    direct, slot_of = [], {}
    for batch in batches:
        for s, img in enumerate(batch.cpu().numpy()):
            slot_of.setdefault(img.tobytes(), (len(direct), s))
        direct.append(detect(batch))
    diffs = {}
    for i, img in enumerate(imgs):
        lb = np.zeros(tuple(canvas_hw) + (3,), np.float32)
        lb[:img.shape[0], :img.shape[1]] = img
        c, s = slot_of.get(lb.tobytes(), (None, None))
        d = ("in no device call's batch" if c is None
             else mismatch(results[i], direct[c][s]))
        if d is not None:
            diffs[i] = d
    canvas_direct = detect(canvas_t)
    slot_dependent = [i for i in range(8)
                      if mismatch(results[i], canvas_direct[i]) is not None]
    n_out = [len(r["boxes"]) for r in results]
    finite = all(np.isfinite(r[k]).all() for r in results
                 for k in ("boxes", "scores", "lm_points") if k in r)
    calls = stats["device_calls"]
    # one int8 conv per conv of the model, and with the hybrid chain one
    # requant after each (the float model launches neither); one window
    # gather per call for a landmark model
    n_conv = len(conv_names(model_cfg)) if quant else 0
    want = {"nms": calls, "qconv": n_conv * calls,
            "requant": n_conv * calls if quant == "hybrid" else 0,
            "window": calls if model_cfg.num_landmarks else 0}
    lm = ({"lm_valid_per_request": [int(r["lm_valid"].sum()) for r in results]}
          if model_cfg.num_landmarks else {})
    emit({"phase": name, "requests": stats["requests"],
          "device_calls": calls, "launches": launches,
          "launches_expected": want,
          "score_thresh": thresh,
          "nms_out_per_request": n_out, **lm,
          "req_per_s": n_req / wall, "p50_ms": float(np.median(lat)) * 1e3,
          "latency_samples": n_req, "finite": finite,
          "served_equals_direct": not diffs, "mismatches": diffs,
          "differ_from_canvas_slot": slot_dependent})
    if not finite or sum(n_out) == 0:
        raise AssertionError(f"{name}: detections not finite or none at all")
    if lm and not sum(lm["lm_valid_per_request"]):
        raise AssertionError(f"{name}: every landmark took the centre "
                             f"fallback")
    if diffs:
        raise AssertionError(f"{name}: served detections differ from a "
                             f"direct detect of the same batches: {diffs}")
    if not calls < stats["requests"] == n_req:
        raise AssertionError(f"{name}: requests were not coalesced: {stats}")
    if calls < 1 or launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} for "
                             f"{calls} device calls, want {want}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import densebox_tpu_torch  # noqa: F401  (alone, without the repo: fail here, silent)

    # f32 parity runs at full f32, as the JAX reference's Precision.HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products (the int8 path's x2 upsample) reduce in f32 as on the
    # CPU, so that the card matches the CPU bit for bit
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    card = card_line()
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phase_build()
    err, (ms, plain_ms) = phase_nms()
    phase_forward()

    launches = {name: phase_serve(f"serve_{name}_bf16", *cfgs)
                for name, *cfgs in serving_cells()}
    q_err, (q_ms, q_plain_ms) = phase_qconv()
    r_err, (r_ms, r_plain_ms) = phase_requant()
    phase_forward_int8()
    _, turbo, turbo_infer, label = serving_cells()[1]
    for quant in ("fused", "hybrid"):
        launches[quant] = phase_serve(f"serve_turbo_int8_{quant}", turbo,
                                      turbo_infer, label, quant=quant)
    w_err, (w_ms, w_plain_ms) = phase_window()
    phase_decode_card_vs_cpu()
    for name, *cfgs, quant in landmark_cells():
        launches[name] = phase_serve(f"serve_{name}", *cfgs, quant=quant,
                                     loc_bias=1.0)

    print(card, flush=True)
    emit({"kernels": [
        {"name": "greedy_nms_keep", "route": "cuda",
         "source": "densebox_tpu_torch/csrc/nms.cu",
         "replaces": "densebox_tpu/ops/pallas/nms.py:28",
         "launches": launches["paper"]["nms"], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms},
        {"name": "qconv_int8", "route": "cuda",
         "source": "densebox_tpu_torch/csrc/qconv.cu",
         "replaces": "densebox_tpu/ops/pallas/qconv.py:59",
         "launches": launches["fused"]["qconv"], "max_abs_err": q_err,
         "ms": q_ms, "plain_ms": q_plain_ms},
        {"name": "requant_epilogue", "route": "cuda",
         "source": "densebox_tpu_torch/csrc/requant.cu",
         "replaces": "densebox_tpu/ops/pallas/requant.py:35",
         "launches": launches["hybrid"]["requant"], "max_abs_err": r_err,
         "ms": r_ms, "plain_ms": r_plain_ms},
        {"name": "gather_windows", "route": "cuda",
         "source": "densebox_tpu_torch/csrc/window.cu",
         "replaces": "densebox_tpu/ops/pallas/window.py:53",
         "launches": launches["malf_bf16"]["window"], "max_abs_err": w_err,
         "ms": w_ms, "plain_ms": w_plain_ms}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
