"""Quality certification: int8 PTQ against bf16 on the same weights.

The port's counterpart of the JAX repository's ``tools/certify_quality.py``
with its ``tools/probes/nme_dist.py`` folded in. Each production config is
trained on the synthetic set through the command line (``cli train
--synthetic``, batch 32, bf16), and the same checkpoint is evaluated
through ``cli eval --synthetic`` twice: in bf16, then with ``--quantize``
(int8 PTQ calibrated on two synthetic canvases). The bar is the JAX
package's claim: int8 AP@0.50 within 0.01 of bf16. For a landmark config
the error distribution of the matched landmarks (in box heights) is added,
in bf16 and in int8.

    python -m densebox_tpu_torch.certify --out CERT.md [--steps 1500]
        [--eval-batches 8] [--configs NAME,...] [--workroot DIR]
        [--device cuda]

Prints one JSON line per config and writes the markdown table to
``--out`` (default: ``QUALITY.md`` in the work root). A work directory
that holds a checkpoint is resumed, so a longer run continues a shorter
one exactly (``train.trainer.fit``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = [
    # (name, stem, trunk_depth, width_mult, landmarks)
    ("fast-s2d2-w0.5", "s2d", 3, 0.5, 0),
    ("fast-s2d4-w0.5", "s2d4", 3, 0.5, 0),
    # the synthetic set's landmarks are the box corners (TL, TR, BR, BL),
    # whose horizontal flip permutes them as (1, 0, 3, 2)
    ("fast-s2d2-w0.5-lm4", "s2d", 3, 0.5, 4),
    ("turbo-s2d4-w0.25", "s2d4", 3, 0.25, 0),
]
# train flags of a landmark config: the flip permutation and, for the
# corners, the box-relative decode anchors
LM_FLAGS = {4: ["--lm-flip-perm", "1,0,3,2",
                "--lm-anchors", "0,0,1,0,1,1,0,1"],
            5: ["--lm-flip-perm", "1,0,2,4,3"]}
BAR = 0.01                      # int8 AP@0.50 at most this far below bf16
NME_BATCHES, NME_BATCH = 4, 8   # the distribution's canvases
# the distribution's statistics beside its count and per-landmark means
STATS = ("mean", "p50", "p75", "p90", "p95", "p99", "frac_gt_0.25",
         "frac_gt_0.5")
COLUMNS = ("config", "steps", "AP@0.50 bf16", "AP@0.50 int8-PTQ", "ΔAP",
           "NME bf16", "NME int8")


def cli_command(*args: str) -> List[str]:
    return [sys.executable, "-m", "densebox_tpu_torch.cli", *args]


def train_command(row: Tuple, workdir: str, steps: int, device: str,
                  batch_size: int = 32) -> List[str]:
    """``cli train`` of one config row ``(name, stem, depth, width, lm)``."""
    _, stem, depth, wm, lm = row
    return cli_command(
        "train", "--synthetic", "--workdir", workdir, "--steps", str(steps),
        "--batch-size", str(batch_size), "--width-mult", str(wm),
        "--stem", stem, "--trunk-depth", str(depth), "--dtype", "bfloat16",
        "--landmarks", str(lm), "--ckpt-every", "500", "--log-every", "100",
        "--device", device, *LM_FLAGS.get(lm, []))


def eval_command(workdir: str, quantize: bool, batches: int, device: str,
                 batch_size: int = 8) -> List[str]:
    return cli_command(
        "eval", "--workdir", workdir, "--synthetic", "--eval-batches",
        str(batches), "--batch-size", str(batch_size), "--device", device,
        *(["--quantize"] if quantize else []))


def run(cmd: Sequence[str], log: str) -> str:
    """Run a command of the port from the repository root, its output
    appended to the file ``log``; returns what it wrote to its standard
    output. A failing command raises, after the end of its output was
    printed to standard error."""
    print("+", " ".join(cmd), file=sys.stderr, flush=True)
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    with open(log, "a") as f:
        f.write(f"+ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    if res.returncode:
        print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
        res.check_returncode()
    return res.stdout


def landmark_errors(dets, batch) -> List[np.ndarray]:
    """Per detection matched to a GT box (``cli._match_landmarks``), the
    distance of each landmark to its GT point in box heights, NaN where the
    GT landmark is not visible."""
    from densebox_tpu_torch.cli import _match_landmarks

    errs = []
    for pred, gt, h, vis in _match_landmarks(dets, batch):
        e = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1) / h
        errs.append(np.where(np.asarray(vis), e, np.nan))
    return errs


def nme_stats(errs: List[np.ndarray]) -> Dict:
    """The distribution of ``landmark_errors``: count, mean, percentiles,
    the shares beyond a quarter and a half box height, and the mean per
    landmark. With no visible matched landmark, the count 0 and the rest
    None."""
    errs = np.stack(errs) if errs else np.zeros((0, 0))     # (N, L)
    flat = errs.ravel()
    flat = flat[~np.isnan(flat)]
    if not flat.size:
        return dict(dict.fromkeys(STATS), n=0, per_landmark_mean=None)
    out = {"n": int(flat.size), "mean": float(flat.mean())}
    for q in (50, 75, 90, 95, 99):
        out[f"p{q}"] = float(np.percentile(flat, q))
    out["frac_gt_0.25"] = float((flat > 0.25).mean())
    out["frac_gt_0.5"] = float((flat > 0.5).mean())
    out["per_landmark_mean"] = np.nanmean(errs, axis=0).tolist()
    return out


def nme_distribution(workdir: str, quantize: bool, device: str) -> Dict:
    """The landmark error distribution of the checkpoint in ``workdir`` over
    ``NME_BATCHES`` synthetic batches of canvases (the eval's seeds), detected
    at the checkpoint's own settings, in bf16 or int8 (calibrated as ``cli
    eval --quantize`` calibrates)."""
    from densebox_tpu_torch import cli
    from densebox_tpu_torch.data import synthetic_batch
    from densebox_tpu_torch.infer import make_detect_fn
    from densebox_tpu_torch.models import DenseBox
    from densebox_tpu_torch.train.checkpoint import load_for_inference

    dev = torch.device(device)
    cfg, params = load_for_inference(os.path.join(workdir, "ckpt"), dev)
    model = DenseBox(cfg.model, device=dev)
    model.load_state_dict(params)
    if quantize:
        model = cli._quantize(model, cfg, None, None, dev)
    detect = make_detect_fn(model.eval(), cfg.infer, cfg.label)
    canvas_cfg = type(cfg.label)(patch_size=4 * cfg.label.patch_size,
                                 std_height_px=cfg.label.std_height_px)
    errs = []
    for i in range(NME_BATCHES):
        gen = torch.Generator(device=dev).manual_seed(1_000_000 + i)
        b = synthetic_batch(gen, NME_BATCH, canvas_cfg,
                            max_boxes=cfg.train.max_boxes,
                            num_landmarks=cfg.model.num_landmarks, device=dev)
        with torch.inference_mode():
            dets = detect(b["image"])
        errs += landmark_errors(dets, b)
    return nme_stats(errs)


def certify_row(row: Tuple, steps: int, eval_batches: int, workroot: str,
                device: str) -> Dict:
    """Train one config row (in ``workroot/<name>``, the commands' output
    in ``workroot/<name>.log``) and evaluate its checkpoint in bf16 and
    int8; the row's result with the wall seconds of each part."""
    name, _, _, _, lm = row
    workdir = os.path.join(workroot, name)
    log = os.path.join(workroot, f"{name}.log")
    os.makedirs(workroot, exist_ok=True)
    seconds = {}
    t_row = t0 = time.perf_counter()
    run(train_command(row, workdir, steps, device), log)
    seconds["train"] = time.perf_counter() - t0
    result = {"config": name, "steps": steps}
    for key, quantize in (("bf16", False), ("int8_ptq", True)):
        t0 = time.perf_counter()
        out = run(eval_command(workdir, quantize, eval_batches, device), log)
        result[key] = json.loads(out.strip().splitlines()[-1])
        seconds[f"eval_{key}"] = time.perf_counter() - t0
    if lm:
        result["nme_dist"] = {}
        for key, quantize in (("bf16", False), ("int8", True)):
            t0 = time.perf_counter()
            result["nme_dist"][key] = nme_distribution(workdir, quantize,
                                                       device)
            seconds[f"nme_dist_{key}"] = time.perf_counter() - t0
    result["delta_ap"] = (result["int8_ptq"]["ap@0.50"]
                          - result["bf16"]["ap@0.50"])
    result["within_bar"] = result["delta_ap"] >= -BAR
    result["seconds"] = dict(seconds, row=time.perf_counter() - t_row)
    return result


def device_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, else
    the device's name."""
    if torch.device(device).type != "cuda":
        return str(device)
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(torch.device(device))


def _nme(summary: Dict) -> str:
    v = summary.get("landmark_nme")
    return "—" if v is None else f"{v:.3f}"


def table(rows: List[Dict], card: str) -> str:
    """The markdown report: the JAX table's columns, then each landmark
    row's error distribution."""
    lines = ["# Quality certification — bf16 vs int8-PTQ (same weights)", "",
             f"Synthetic runs on {card}, batch 32, bf16 training; eval = "
             "the full pyramid pipeline at threshold 0.3. Generated by "
             "`python -m densebox_tpu_torch.certify`.", "",
             "| " + " | ".join(COLUMNS) + " |",
             "|" + "---|" * len(COLUMNS)]
    for r in rows:
        b, q = r["bf16"], r["int8_ptq"]
        lines.append(f"| {r['config']} | {r['steps']} | {b['ap@0.50']:.3f} | "
                     f"{q['ap@0.50']:.3f} | {r['delta_ap']:+.3f} | "
                     f"{_nme(b)} | {_nme(q)} |")
    for r in rows:
        if "nme_dist" not in r:
            continue
        lines += ["", f"Landmark error distribution of {r['config']} "
                  f"({r['steps']} steps; box heights):", "",
                  "| decode | n | mean | p50 | p75 | p90 | p95 | p99 | "
                  "> 0.25 | > 0.5 | per landmark |", "|" + "---|" * 11]
        for key, d in r["nme_dist"].items():
            per = ", ".join(f"{v:.4f}" for v in d["per_landmark_mean"] or [])
            lines.append(f"| {key} | {d['n']} | " + " | ".join(
                "—" if d[k] is None else f"{d[k]:.4f}" for k in STATS)
                + f" | {per or '—'} |")
    return "\n".join(lines) + "\n"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m densebox_tpu_torch.certify",
        description="int8 PTQ against bf16 on the same trained weights")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval-batches", type=int, default=8)
    ap.add_argument("--workroot", default=os.path.join(
        tempfile.gettempdir(), "densebox_torch_cert"))
    ap.add_argument("--out", default=None,
                    help="markdown table (default: QUALITY.md in --workroot)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of config names")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    from densebox_tpu_torch.device import resolve_device

    ap = parser()
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    names = set(args.configs.split(",")) if args.configs else None
    unknown = (names or set()) - {r[0] for r in CONFIGS}
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}")

    card = device_line(device)
    print(card, flush=True)
    rows = []
    for row in CONFIGS:
        if names and row[0] not in names:
            continue
        result = certify_row(row, args.steps, args.eval_batches,
                             args.workroot, device)
        print(json.dumps(dict(result, card=card)), flush=True)
        rows.append(result)
    out = args.out or os.path.join(args.workroot, "QUALITY.md")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(table(rows, card))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
