"""Serving load test of the port: concurrent clients against
``DetectServer`` (port of ``tools/probes/serve_loadtest.py``).

    # the headline turbo int8 model (random weights), 480x640 canvas, card
    python -m densebox_tpu_torch.loadtest --turbo-int8 --clients 1 8 16 32

    # a tiny model trained here through ``cli train --synthetic``, 96x128
    python -m densebox_tpu_torch.loadtest --device cpu --clients 1 4

For each client count a fresh server takes ``--requests`` requests from
that many closed-loop clients (each submits its own scene, waits for the
answer, submits again, until the shared budget is spent) and one JSON line
is printed: requests/s, the p50 and p99 latency of ``submit()``, the
coalescing ratio (requests per device call), the device calls, max_batch,
the canvas and the device. The training run's log goes to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from densebox_tpu_torch.config import InferCfg, LabelCfg, ModelCfg
from densebox_tpu_torch.device import device_name, resolve_device
from densebox_tpu_torch.serve import DetectServer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m densebox_tpu_torch.loadtest",
        description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, nargs="+", default=[16])
    ap.add_argument("--requests", type=int, default=96,
                    help="requests per client count")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=5.0)
    ap.add_argument("--canvas", type=int, nargs=2, default=None,
                    help="default: 96x128 (tiny) / 480x640 (--turbo-int8)")
    ap.add_argument("--turbo-int8", action="store_true",
                    help="serve the headline turbo int8 config (random "
                         "weights: serving latency does not depend on them) "
                         "instead of training a tiny model first")
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the CUDA card)")
    return ap.parse_args(argv)


def scene(seed: int, hw: Tuple[int, int]) -> np.ndarray:
    """A client's request: dim noise with one bright square, in [0, 1]."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(*hw, 3) * 40).astype(np.float32)
    img[30:52, 40:62] = 230.0
    return img / 255.0


def run_level(make_server: Callable[[], DetectServer], n_clients: int,
              requests: int, canvas: Tuple[int, int]) -> Dict:
    """``requests`` requests from ``n_clients`` closed-loop clients against
    a fresh server from ``make_server``; prints and returns the level's
    JSON line."""
    server = make_server()
    lats: List[float] = []
    issued = 0
    lock = threading.Lock()

    def client(cid):
        nonlocal issued
        img = scene(cid, canvas)
        while True:
            with lock:
                if issued >= requests:
                    return
                issued += 1
            t0 = time.perf_counter()
            server.submit(img)
            with lock:
                lats.append(time.perf_counter() - t0)

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        stats = dict(server.stats)
    finally:
        server.close()
    lats_ms = np.sort(np.asarray(lats)) * 1e3
    line = {
        "clients": n_clients, "requests": len(lats),
        "req_per_s": len(lats) / dt,
        "p50_ms": float(np.percentile(lats_ms, 50)),
        "p99_ms": float(np.percentile(lats_ms, 99)),
        "coalescing_ratio": stats["requests"] / max(stats["device_calls"], 1),
        "device_calls": stats["device_calls"],
        "max_batch": server.max_batch, "canvas": list(canvas),
        "device": device_name(server.device)}
    print(json.dumps(line), flush=True)
    return line


def turbo_server(canvas: Tuple[int, int], max_batch: int, window_ms: float,
                 device) -> Callable[[], DetectServer]:
    """A factory of servers of the headline turbo int8 model (stem s2d4,
    depth 3, width 0.25) with seeded random weights, calibrated on two
    uniform canvases, at one scale."""
    from densebox_tpu_torch.models import (QuantDenseBox, init_params,
                                           quantize_densebox)

    dev = resolve_device(device)
    cfg = ModelCfg(width_mult=0.25, compute_dtype="bfloat16", stem="s2d4",
                   trunk_depth=3)
    params = init_params(cfg, torch.Generator().manual_seed(1))
    gen = torch.Generator(device=dev).manual_seed(0)
    calib = torch.rand((2,) + tuple(canvas) + (3,), generator=gen, device=dev)
    model = QuantDenseBox(cfg, device=dev)
    model.load_state_dict(quantize_densebox(params, cfg, calib))
    icfg = InferCfg(scales=(1.0,), score_thresh=0.5, topk_per_scale=256,
                    max_dets=128)
    return lambda: DetectServer(model, icfg, LabelCfg(), canvas_hw=canvas,
                                max_batch=max_batch,
                                batch_window_ms=window_ms, device=dev)


def tiny_server(workdir: str, canvas: Tuple[int, int], max_batch: int,
                window_ms: float, device) -> Callable[[], DetectServer]:
    """A factory of servers of a tiny model trained first by ``cli train
    --synthetic`` (20 steps, width 0.125, 64 px patches) into
    ``workdir``, loaded by ``load_for_inference``."""
    from densebox_tpu_torch.cli import main as cli_main
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train.checkpoint import load_for_inference

    dev = resolve_device(device)
    run = os.path.join(workdir, "run")
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(["train", "--synthetic", "--workdir", run,
                       "--steps", "20", "--batch-size", "8",
                       "--width-mult", "0.125", "--patch-size", "64",
                       "--std-height", "20", "--max-boxes", "3",
                       "--ckpt-every", "10", "--log-every", "10",
                       "--device", str(dev)])
    if rc != 0:
        raise RuntimeError(f"cli train exited {rc}")
    cfg, params = load_for_inference(os.path.join(run, "ckpt"), device=dev)
    model = DenseBox(cfg.model, device=dev)
    model.load_state_dict(params)
    return lambda: DetectServer(model, cfg.infer, cfg.label,
                                canvas_hw=canvas, max_batch=max_batch,
                                batch_window_ms=window_ms, device=dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    canvas = tuple(args.canvas or ((480, 640) if args.turbo_int8
                                   else (96, 128)))
    opts = (canvas, args.max_batch, args.window_ms, args.device)
    with contextlib.ExitStack() as stack:
        if args.turbo_int8:
            factory = turbo_server(*opts)
        else:
            td = stack.enter_context(tempfile.TemporaryDirectory())
            factory = tiny_server(td, *opts)
        for n in args.clients:
            run_level(factory, n, args.requests, canvas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
