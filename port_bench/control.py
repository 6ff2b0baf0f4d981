"""The control of a cell: the reference put in the program's place, one
precision below the cell's (int8 -> int4 codes; bfloat16 -> float8 e4m3;
float32 -> TF32; a detector's decode in bfloat16), on the same weights and
inputs, judged by the same comparison. It has to come out not correct; its
numbers are the upper readings the limits are set below.

    python3 -m port_bench.control --workload <name> --seed <n> [...]

Prints one JSON line per seed with the numbers and whether they pass the
cell's limits (a data-parallel train cell's line adds its faults planted
in the reference, ``train_dp_control``). The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from port_bench import detection, harness
from port_bench.reference import compare, detect as ref_detect, model as ref

INT4 = 7


def train_control(c, seed: int, device) -> dict:
    """A float32 train cell's control: the reference's steps with TF32 on
    in the program's place."""
    from port_bench.reference import train as ref_train

    drv = harness.driver("train", c.root)
    conf, pool, weights, draws_of = drv.inputs(c, seed, device)
    n = drv.COMPARED_STEPS
    batches = [pool[i % len(pool)] for i in range(n)]
    draws = [draws_of(i) for i in range(n)]
    losses, trace, after, _ = ref_train.steps(weights, conf, batches, draws,
                                              tf32=True)
    return drv.check(conf, weights, batches, draws, losses, trace, after)


def _rows(tree, idx):
    """Rows ``idx`` of every tensor of a (nested) dict of batch-first
    tensors."""
    return {k: _rows(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def train_dp_control(c, seed: int, device):
    """A data-parallel train cell's control: the reference's steps on the
    global batch with TF32 on in the program's place (``rank_gap`` has no
    reading: the reference has no ranks). Besides, the faults of the
    program planted in the reference at the cell's size, each judged the
    same way: ``half_batch`` (each rank's loss over the first half of its
    rows), ``averaged`` (the gradients' sum divided by the ranks),
    ``shifted_shard`` (rank 1 takes the draws of the rows one past its
    own) and ``no_exchange`` (rank 0 steps on its own rows' gradient over
    the global counts: its gradient and change; its losses, summed over
    ranks that went apart, are not followed)."""
    from port_bench.reference import train as ref_train

    drv = harness.driver("train_dp", c.root)
    single = harness.driver("train", c.root)
    conf = drv.conf_of(c)
    n, b, world = drv.COMPARED_STEPS, drv.rank_size(c), c.entry["chips"]
    weights = drv.weights_of(c, conf, seed, device)
    batches = [drv.global_batch(c, seed, i, device) for i in range(n)]
    draws = [drv.global_draws(c, conf, seed, i, device) for i in range(n)]

    def judged(bt, dr, **kw):
        losses, trace, after, norms = ref_train.steps(weights, conf, bt, dr,
                                                      **kw)
        numbers, readings = single.check(conf, weights, batches, draws,
                                         losses, trace, after)
        readings["grad_norm"] = float(np.sqrt(sum(v * v
                                                  for v in norms.values())))
        return numbers, readings

    numbers, readings = judged(batches, draws, tf32=True)
    idx = torch.arange(b * world, device=device)
    half = idx[idx % b < b // 2]
    shifted = idx.clone()
    shifted[b:2 * b] += 1
    rank0 = idx < b
    faults = {
        "half_batch": judged([_rows(x, half) for x in batches],
                             [_rows(d, half) for d in draws])[0],
        "averaged": judged(batches, draws, grad_scale=1.0 / world)[0],
        "shifted_shard": judged(batches, [_rows(d, shifted)
                                          for d in draws])[0],
        "no_exchange": {k: v for k, v in judged(batches, draws,
                                                rows=rank0)[0].items()
                        if k != "loss_gap"}}
    return numbers, readings, faults


def control_side(cell, group, weights, calib, images):
    """(scales in the program's names or None, per-image levels, per-image
    detections) of the control on (N, H, W, 3) ``images``."""
    conf = cell.config["config"]
    scales = None
    if cell.spec["precision"] == "int8":
        w32 = {k: v.float() for k, v in weights.items()}
        q = ref.calibrate(w32, group, calib, qmax=INT4)
        scales = {f"{n}.{k}": c[k] for n, c in q.items()
                  for k in ("in_scale", "w_scale")}

        def fwd(x):
            return ref.forward_int8(q, group, x, qmax=INT4)
    else:
        def fwd(x):
            return ref.forward_float(weights, group, x, fp8=True)
    hw = tuple(images.shape[1:3])
    levels, dets = [], []
    for j in range(images.shape[0]):
        lv = ref.pyramid(fwd, images[j:j + 1], conf["infer"]["scales"])
        levels.append([m for m, _ in lv])
        dets.append(ref_detect.detect(lv, hw, conf["infer"], conf["label"],
                                      dtype=torch.bfloat16))
    return scales, levels, dets


def run_control(name: str, seed: int, device, root=harness.ROOT,
                overrides=None) -> dict:
    c = harness.cell(name, root)
    over = overrides or {}
    c.config = harness.merged(c.config, over.get("config"))
    c.traffic = harness.merged(c.traffic, over.get("traffic"))
    c.spec = harness.merged(c.spec, over.get("spec"))
    device = torch.device(device)
    tr, spec = c.traffic, c.spec
    if tr["mode"] == "train":
        numbers, readings = train_control(c, seed, device)
        correct, checks = compare.judge(numbers, spec["limits"])
        return {"workload": name, "seed": seed, "correct": correct,
                "checks": checks, "readings": readings}
    if tr["mode"] == "train_dp":
        numbers, readings, faults = train_dp_control(c, seed, device)
        correct, checks = compare.judge(numbers, spec["limits"])
        return {"workload": name, "seed": seed, "correct": correct,
                "checks": checks, "grad_norm": readings["grad_norm"],
                "faults": {k: compare.judge(v, spec["limits"])[1]
                           for k, v in faults.items()}}
    group, rng, pool, weights, calib = detection.inputs(c, seed, device)
    n = (spec["compare_calls"] * spec["compare_images"]
         if tr["mode"] == "offline" else spec["compare_scenes"])
    idx = np.sort(rng.choice(tr["pool"], n, replace=False))
    images = pool.index_select(0, torch.as_tensor(idx, device=device))
    scales, levels, dets = control_side(c, group, weights, calib, images)
    hw = tuple(tr["canvas"])
    drv = harness.driver(tr["mode"], root)
    if tr["mode"] == "offline":
        cat = [{k: torch.cat([lv[i][k] for lv in levels]) for k in levels[0][i]}
               for i in range(len(levels[0]))]
        out = {k: torch.cat([d[k] for d in dets]) for k in dets[0]}
        rows = torch.arange(n, device=device)
        numbers, by_map = drv.check(c, group, weights, calib, {0: (cat, out)},
                                    {0: (images, rows)}, scales, hw)
    else:
        kept = {int(s): (levels[j], images[j:j + 1], 0)
                for j, s in enumerate(idx)}
        answers = {int(s): [compare.answer(dets[j], 0)]
                   for j, s in enumerate(idx)}
        numbers, by_map = drv.check(c, group, weights, calib, kept, answers,
                                    scales, hw)
    correct, checks = compare.judge(numbers, spec["limits"])
    return {"workload": name, "seed": seed, "correct": correct,
            "checks": checks, "map_gaps": by_map}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seed:
        print(json.dumps(run_control(args.workload, s, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
