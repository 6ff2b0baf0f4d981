"""The port's bench on one CUDA card: images/s of the dense 640x480 detect
pipeline, or train steps/s (port of the repository's root ``bench.py``,
which benches the JAX package on a TPU: its numbers are a TPU's).

    python -m densebox_tpu_torch.bench                    # turbo int8, B=256
    python -m densebox_tpu_torch.bench --preset paper --dtype bfloat16
    python -m densebox_tpu_torch.bench --preset fast      # int8, B=128
    python -m densebox_tpu_torch.bench --mode train       # canvas train step
    python -m densebox_tpu_torch.bench --smoke --device cpu

Prints an info line on stderr, then as the last line of stdout one JSON
object {"metric", "value", "unit", "vs_baseline"}; ``vs_baseline`` is null,
since the JAX bench's divisors (5000 images/s, 25 steps/s) are a TPU's
bars. A failure prints one JSON line {"error", "stage", "device", "value":
null} in its place and exits 1: stage "device-init" when there is no CUDA
card and no --device names another device, "run" when building or timing
fails.

Timing: one untimed pass first (the kernels build and cuDNN picks its
algorithms there), then --repeats passes of --iters calls each, the inputs
already on the device; a pass is timed by CUDA events around its calls and
synchronised once at its end (on the CPU by the host clock). ``value`` is
read at the median pass, since one card's passes swing by tens of percent
from call to call; the best pass is in the info line beside it.

Left out of the JAX bench: its backend probe and compile guard, and its
TPU A/B flags (--remat, --ohem-backend, --canvas-dtype, --dropout-impl,
--skip-fusion, --pool-impl, --head-impl, --up-int8, --head-fuse, --tail,
--lm-window-dp). Top-k is exact in the port, so the metric says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from densebox_tpu_torch.config import (DenseBoxConfig, InferCfg, LabelCfg,
                                       ModelCfg, TrainCfg,
                                       resolved_canvas_dtype)
from densebox_tpu_torch.device import device_name, resolve_device
from densebox_tpu_torch.infer import detect_batch

# per-preset stem, trunk depth, width and batch, as the JAX bench's
PRESETS = {"paper": dict(stem="conv", depth=4, wm=1.0, batch=64),
           "fast": dict(stem="s2d", depth=3, wm=0.5, batch=128),
           "turbo": dict(stem="s2d4", depth=3, wm=0.25, batch=256)}
INFER_METRIC = ("640x480 images/sec/chip (dense inference, full decode+NMS "
                "pipeline, exact top-k)")
IMAGE_SEED, PARAM_SEED = 0, 1


def emit_failure(stage: str, detail: str, device: str) -> None:
    """Print the one structured failure line and exit 1."""
    print(json.dumps({"error": detail, "stage": stage, "device": device,
                      "value": None}), flush=True)
    sys.exit(1)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m densebox_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="default per preset: paper 64 / fast 128 / turbo 256")
    ap.add_argument("--width-mult", type=float, default=None)
    ap.add_argument("--dtype", default="int8",
                    choices=["int8", "bfloat16", "float32"],
                    help="int8 = post-training quantised, bf16 around the "
                         "int8 chain")
    ap.add_argument("--iters", type=int, default=8,
                    help="pipeline calls (or train steps) in a timed pass")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed passes; the median is reported")
    ap.add_argument("--scales", default="1.0",
                    help="comma-separated pyramid scales")
    ap.add_argument("--landmarks", type=int, default=0,
                    help="landmark heads (with the refine branch when > 0)")
    ap.add_argument("--patch", type=int, default=240,
                    help="train-mode patch size")
    ap.add_argument("--preset", default="turbo", choices=sorted(PRESETS),
                    help="turbo: s2d4 stem, depth 3, width 0.25, B=256; "
                         "fast: s2d stem, depth 3, width 0.5, B=128; "
                         "paper: the DenseBox architecture, B=64")
    ap.add_argument("--lm-dtype", default="auto",
                    choices=["auto", "float32", "bfloat16"],
                    help="landmark heatmap dtype through the window gather "
                         "and peak search")
    ap.add_argument("--qbackend", default="fused",
                    choices=["fused", "hybrid", "xla"],
                    help="int8 chain: fused (int8 conv with its epilogue), "
                         "hybrid (int32 conv, then the requant kernel) or "
                         "xla (int32 conv, epilogue in torch)")
    ap.add_argument("--refine-width", type=int, default=None)
    ap.add_argument("--stem", default=None, choices=["conv", "s2d", "s2d4"],
                    help="override the preset's stem")
    ap.add_argument("--trunk-depth", type=int, default=None,
                    help="override the preset's convs per conv3/conv4 block")
    ap.add_argument("--mode", default="infer", choices=["infer", "train"],
                    help="infer = images/s of the detect pipeline; train = "
                         "steps/s of the canvas train step (patch sampling, "
                         "GT rasterization, OHEM loss, SGD)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes (96x128, B=2, width 0.125, 2 iters, "
                         "64 px patches) on the device given")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the CUDA card)")
    return ap.parse_args(argv)


def run_shape(args) -> Tuple[Tuple[int, int], int, float, int, int]:
    """((H, W), batch, width_mult, iters, patch) of a run."""
    if args.smoke:
        return (96, 128), 2, 0.125, 2, 64
    preset = PRESETS[args.preset]
    return ((480, 640), args.batch or preset["batch"],
            args.width_mult or preset["wm"], args.iters, args.patch)


def model_cfg(args, width_mult: float) -> ModelCfg:
    """The preset's model, with the flags' overrides; int8 computes in
    bfloat16 around the int8 chain, and trains in it."""
    preset = PRESETS[args.preset]
    return ModelCfg(
        num_landmarks=args.landmarks, use_refine=args.landmarks > 0,
        width_mult=width_mult,
        compute_dtype="bfloat16" if args.dtype == "int8" else args.dtype,
        stem=args.stem or preset["stem"],
        trunk_depth=args.trunk_depth or preset["depth"],
        refine_width=(args.refine_width if args.refine_width is not None
                      else ModelCfg.refine_width))


def infer_cfg(args) -> InferCfg:
    return InferCfg(scales=tuple(float(s) for s in args.scales.split(",")),
                    score_thresh=0.5, topk_per_scale=256, max_dets=128,
                    lm_dtype=args.lm_dtype)


def build_infer(cfg: ModelCfg, int8: bool, qbackend: str, batch: int,
                hw: Tuple[int, int], device, params=None, qparams=None,
                images=None):
    """(model, images) on ``device``: the float ``DenseBox`` with
    ``params`` (a float state dict; else seeded ``init_params``) or, with
    ``int8``, its ``QuantDenseBox`` on ``qbackend`` with ``qparams`` (an
    int8 state dict) or else calibrated by ``quantize_densebox`` on the
    first two images in float32. ``images`` (B, H, W, 3) in [0, 1], numpy
    or a tensor, are cast to the compute dtype; without them a seeded
    generator on the device draws them uniform in [0, 1) in that dtype."""
    from densebox_tpu_torch.models import (DenseBox, QuantDenseBox,
                                           init_params, quantize_densebox)

    dev = resolve_device(device)
    dtype = getattr(torch, cfg.compute_dtype)
    if images is None:
        gen = torch.Generator(device=dev).manual_seed(IMAGE_SEED)
        images = torch.rand((batch,) + tuple(hw) + (3,), generator=gen,
                            device=dev, dtype=dtype)
    else:
        images = torch.as_tensor(np.asarray(images)).to(dev, dtype)
    if params is None and qparams is None:
        params = init_params(cfg, torch.Generator().manual_seed(PARAM_SEED))
    if not int8:
        model = DenseBox(cfg, device=dev)
        model.load_state_dict(params)
        return model.eval(), images
    if qparams is None:
        qparams = quantize_densebox(params, cfg, images[:2].float())
    model = QuantDenseBox(cfg, backend=qbackend, device=dev)
    model.load_state_dict(qparams)
    return model.eval(), images


def perturbations(iters: int, images: torch.Tensor) -> torch.Tensor:
    """(iters,) steps i * 1e-6 in the images' dtype, each rounded as the
    JAX bench rounds it (i and 1e-6 cast first, then their product)."""
    dtype = images.dtype
    return (torch.arange(iters, device=images.device).to(dtype)
            * torch.tensor(1e-6, dtype=dtype, device=images.device))


def pipeline(model, images: torch.Tensor, icfg: InferCfg, lcfg: LabelCfg,
             iters: int) -> torch.Tensor:
    """One pass: ``detect_batch`` of ``images + i * 1e-6`` for i < ``iters``,
    every output summed into a float32 checksum on the device (non-finite
    values as 0), so that every output is consumed. No synchronisation."""
    steps = perturbations(iters, images)
    total = torch.zeros((), dtype=torch.float32, device=images.device)
    with torch.inference_mode():
        for i in range(iters):
            out = detect_batch(model, images + steps[i], icfg, lcfg)
            for v in out.values():
                vf = v.float()
                total = total + torch.where(torch.isfinite(vf), vf, 0.0).sum()
    return total


def timed_passes(run: Callable[[], torch.Tensor], repeats: int,
                 device: torch.device) -> Dict:
    """One untimed pass, then ``repeats`` timed ones (CUDA events on the
    card, else the host clock). Returns the warm-up's seconds, every
    timed pass's seconds, the last pass's value and the kernel launches
    of that pass."""
    from densebox_tpu_torch.ops.kernels import (launch_counts,
                                                reset_launch_counts)

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    value = float(run())
    warmup_s = time.perf_counter() - t0
    seconds = []
    for _ in range(repeats):
        reset_launch_counts()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            t = time.perf_counter()
            out = run()
            float(out)
            seconds.append(time.perf_counter() - t)
        value = float(out)
    return {"warmup_s": warmup_s, "seconds": seconds, "value": value,
            "launches": launch_counts()}


def spread_ms(seconds: List[float], per: int) -> Dict[str, float]:
    """Median, best and quartiles of the passes, in ms per unit of work."""
    ms = np.asarray(seconds) * 1e3 / per
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": float(med), "best": float(ms.min()), "q1": float(q1),
            "q3": float(q3)}


def bench_infer(args, device) -> Tuple[Dict, Dict]:
    hw, batch, wm, iters, _ = run_shape(args)
    cfg = model_cfg(args, wm)
    icfg, lcfg = infer_cfg(args), LabelCfg()
    model, images = build_infer(cfg, args.dtype == "int8", args.qbackend,
                                batch, hw, device)
    res = timed_passes(lambda: pipeline(model, images, icfg, lcfg, iters),
                       args.repeats, device)
    med = float(np.median(res["seconds"]))
    info = {"device": device_name(device), "preset": args.preset,
            "batch": batch, "hw": list(hw), "width_mult": wm,
            "dtype": args.dtype,
            "qbackend": args.qbackend if args.dtype == "int8" else None,
            "scales": list(icfg.scales), "landmarks": args.landmarks,
            "iters": iters, "repeats": args.repeats,
            "warmup_s": res["warmup_s"],
            "ms_per_image": spread_ms(res["seconds"], batch * iters),
            "checksum": res["value"], "launches_per_pass": res["launches"]}
    line = {"metric": INFER_METRIC, "value": batch * iters / med,
            "unit": "images/sec/chip", "vs_baseline": None}
    return info, line


def build_train(cfg: ModelCfg, batch: int, patch: int, device):
    """(train state, canvas train step, batch) of the train bench:
    ``batch`` synthetic canvases of 2 x ``patch`` px (at most 8 boxes,
    standard height 50 px per 240 px of patch) drawn on ``device``."""
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train import (create_train_state,
                                          make_canvas_train_step)

    dcfg = DenseBoxConfig(
        model=cfg, label=LabelCfg(patch_size=patch,
                                  std_height_px=50.0 * patch / 240),
        train=TrainCfg(batch_size=batch))
    canvas = LabelCfg(patch_size=2 * patch,
                      std_height_px=dcfg.label.std_height_px)
    gen = torch.Generator(device=device).manual_seed(IMAGE_SEED)
    data = synthetic_batch(gen, batch, canvas, max_boxes=8,
                           image_dtype=getattr(torch,
                                               resolved_canvas_dtype(dcfg)),
                           device=device)
    model = DenseBox(cfg, device=device)
    state = create_train_state(model, dcfg, device)
    return state, make_canvas_train_step(model, dcfg, device=device), data


def bench_train(args, device) -> Tuple[Dict, Dict]:
    _, batch, wm, iters, patch = run_shape(args)
    cfg = model_cfg(args, wm)
    state, step, data = build_train(cfg, batch, patch, device)

    def run():
        total = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            total = total + step(state, data)[1]["loss_total"]
        return total

    res = timed_passes(run, args.repeats, device)
    med = float(np.median(res["seconds"]))
    info = {"device": device_name(device), "preset": args.preset,
            "mode": "train", "batch": batch, "patch": patch,
            "width_mult": wm, "dtype": cfg.compute_dtype,
            "landmarks": args.landmarks, "iters": iters,
            "repeats": args.repeats, "warmup_s": res["warmup_s"],
            "ms_per_step": spread_ms(res["seconds"], iters),
            "loss_total_sum": res["value"],
            "launches_per_pass": res["launches"]}
    line = {"metric": f"train steps/sec (batch {batch}, {patch}px patches, "
                      "on-device GT+OHEM+SGD)",
            "value": iters / med, "unit": "steps/sec", "vs_baseline": None}
    return info, line


def main(argv=None) -> int:
    args = parse_args(argv)
    asked = args.device or "cuda"
    device = torch.device(asked)
    if device.type == "cuda" and not torch.cuda.is_available():
        emit_failure("device-init", "no CUDA card: torch.cuda.is_available() "
                     "is false; pass --device cpu to run on the CPU", asked)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        info, line = (bench_train if args.mode == "train" else
                      bench_infer)(args, device)
    except Exception as e:  # noqa: BLE001 - the last line must stay parseable
        emit_failure("run", f"{type(e).__name__}: {e}", asked)
    if device.type == "cuda":
        info["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    print(json.dumps(info), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
