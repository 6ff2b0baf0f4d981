#!/usr/bin/env python3
"""Drive the PyTorch port's detect-and-serve path once on an NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (each prints one JSON line; any failure raises, so the exit code is
not 0):
  1. no card, no run: without CUDA the script exits 1 with no result;
  2. the card's name and power limit (nvidia-smi);
  3. build the CUDA NMS kernel from densebox_tpu_torch/csrc with nvcc;
  4. NMS kernel against its plain PyTorch version on the card (B=8,
     K in {256, 512, 1024}, random boxes and IoU-on-threshold pairs: keep
     masks, indices, boxes and scores identical), with median times;
  5. the paper model (width 1.0) forward in f32 on the card against the
     port on the CPU (TF32 off; 1e-3 absolute), then a bf16 forward;
  6. serve: a DetectServer with the paper model in bf16, 480x640 canvas,
     max_batch 8, the preset's 4-scale pyramid; 24 requests from 8 threads,
     answered, coalesced, and equal to a direct detect of the same images;
  7. the same serve run with the turbo trunk (s2d4, depth 3, width 0.25).
The kernel launch counter is reset just before each serve run's requests
and must have grown by the end of it. The line before the last lists the
kernels, after the card line again; the last line is
{"ok": true, "device": {...}}.

Weights are random (torch.Generator seeds), so detections are not
meaningful objects: the score threshold of the serve phases is set from
the model's own score map so that candidates reach NMS.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


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
    lib = build.build("nms")
    build.load("nms")
    log = lib.with_suffix(".log").read_text().splitlines()
    emit({"phase": "build", "kernel": "nms", "seconds": time.perf_counter() - t0,
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


def init_model(cfg, device, seed=0):
    import torch

    from densebox_tpu_torch.models import DenseBox, init_params

    model = DenseBox(cfg, device=device)
    model.load_state_dict(init_params(cfg, torch.Generator().manual_seed(seed)))
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


def with_live_threshold(model, batch, infer_cfg):
    """Random weights: put ``score_thresh`` at the 99th percentile of the
    scale-1 score map of `batch`, so that candidates reach NMS."""
    import torch

    with torch.inference_mode():
        smap = model(batch)["score"]
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


def mismatch(res, boxes, scores):
    """None if the served result `res` equals the direct detect (boxes,
    scores) exactly, else what differs."""
    if (np.array_equal(res["boxes"], boxes)
            and np.array_equal(res["scores"], scores)):
        return None
    out = {"served": len(res["boxes"]), "direct": len(boxes)}
    if len(boxes) == len(res["boxes"]):
        out["max_box_diff"] = float(np.abs(res["boxes"] - boxes).max(initial=0))
        out["max_score_diff"] = float(
            np.abs(res["scores"] - scores).max(initial=0))
    return out


def phase_serve(name, model_cfg, infer_cfg, label_cfg, canvas_hw=(480, 640),
                n_req=24, n_threads=8):
    import torch

    from densebox_tpu_torch.infer import candidates
    from densebox_tpu_torch.ops.kernels import nms as knms
    from densebox_tpu_torch.ops.nms import nms
    from densebox_tpu_torch.serve import DetectServer

    model = init_model(model_cfg, "cuda")
    imgs = request_images(n_req, canvas_hw, seed=3)
    canvas = np.zeros((8,) + tuple(canvas_hw) + (3,), np.float32)
    for i in range(8):
        h, w = imgs[i].shape[:2]
        canvas[i, :h, :w] = imgs[i]
    canvas_t = torch.from_numpy(canvas).cuda()
    infer_cfg = with_live_threshold(model, canvas_t, infer_cfg)
    thresh = infer_cfg.score_thresh

    server = DetectServer(model, infer_cfg, label_cfg, canvas_hw=canvas_hw,
                          max_batch=8, batch_window_ms=15.0)
    results, lat = [None] * n_req, [None] * n_req
    try:
        knms.reset_launches()
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
        launches = knms.launches
        stats = dict(server.stats)
    finally:
        server.close()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"{name}: not every request was answered")
    # The first 8 requests were served letterboxed as in `canvas` (no
    # downscale, so no change of coordinates), in some slot of some device
    # call. An image's maps on the card do not depend on its slot or on the
    # other images in the batch, so each served result must equal a direct
    # detect of `canvas` bit for bit.
    with torch.inference_mode():
        cand = candidates(model, canvas_t, infer_cfg, label_cfg)
        boxes, scores, valid = (t.cpu().numpy() for t in nms(
            *cand, iou_thresh=infer_cfg.nms_iou, max_out=infer_cfg.max_dets))
    diffs = {i: d for i in range(8)
             if (d := mismatch(results[i], boxes[i][valid[i]],
                               scores[i][valid[i]])) is not None}
    n_out = [len(r["boxes"]) for r in results]
    finite = all(np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
                 for r in results)
    emit({"phase": name, "requests": stats["requests"],
          "device_calls": stats["device_calls"], "nms_launches": launches,
          "score_thresh": thresh,
          "nms_in_per_image": cand[2].sum(1).tolist(),
          "nms_out_per_request": n_out,
          "req_per_s": n_req / wall, "p50_ms": float(np.median(lat)) * 1e3,
          "latency_samples": n_req, "finite": finite,
          "served_equals_direct": not diffs, "mismatches": diffs})
    if not finite or sum(n_out) == 0:
        raise AssertionError(f"{name}: detections not finite or none at all")
    if diffs:
        raise AssertionError(f"{name}: served detections differ from a "
                             f"direct detect of the same canvases: {diffs}")
    if not stats["device_calls"] < stats["requests"] == n_req:
        raise AssertionError(f"{name}: requests were not coalesced: {stats}")
    if launches < 1 or launches != stats["device_calls"]:
        raise AssertionError(f"{name}: NMS kernel launches {launches} for "
                             f"{stats['device_calls']} device calls")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    # f32 parity runs at full f32, as the JAX reference's Precision.HIGHEST
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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

    print(card, flush=True)
    emit({"kernels": [{
        "name": "greedy_nms_keep", "route": "cuda",
        "source": "densebox_tpu_torch/csrc/nms.cu",
        "replaces": "densebox_tpu/ops/pallas/nms.py:28",
        "launches": launches["paper"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
