"""What the detection drivers (``drivers/offline.py``, ``drivers/serve.py``)
and their control share: a run's inputs made from the seed, and the
reference's forward at the cell's precision."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from port_bench import harness, program
from port_bench.reference import model as ref
from port_bench.traffic.scenes import scene_pool
from port_bench.weights import make_weights


class Inputs(NamedTuple):
    group: dict                    # the model group at the cell's precision
    rng: np.random.Generator       # the run's draws of order, after calib
    pool: torch.Tensor             # (n, H, W, 3) scenes on the device
    weights: Dict[str, torch.Tensor]
    calib: torch.Tensor            # the int8 calibration scenes


def inputs(cell, seed: int, device) -> Inputs:
    """The scenes, the weights and the calibration scenes of a run, all
    made on ``device`` from the seed."""
    tr = cell.traffic
    group = program.model_group(cell)
    rng = np.random.default_rng(harness.subseed(seed, "order"))
    gen = torch.Generator(device=device).manual_seed(
        harness.subseed(seed, "scenes"))
    pool = scene_pool(tr["pool"], tr["canvas"], tr["scene"], tr["objects"],
                      gen)
    weights = make_weights(group, cell.config["assumed"]["biases"],
                           harness.subseed(seed, "weights"), device,
                           getattr(torch, group["param_dtype"]))
    calib = pool.index_select(0, torch.as_tensor(
        rng.permutation(tr["pool"])[:cell.spec.get("calib_images", 0)],
        device=device))
    return Inputs(group, rng, pool, weights, calib)


def reference_forward(cell, group, weights, calib):
    """(forward of (B, H, W, 3) images, the reference's own int8
    calibration or None) at the cell's precision. The int8 chain runs on
    the reference's own scales, calibrated from the same weights and
    calibration scenes, with its own weight codes and exact integer sums:
    nothing of the program's calibration enters it (``scale_gap`` holds
    the program's scales to the same calibration)."""
    if cell.spec["precision"] == "int8":
        w32 = {k: v.float() for k, v in weights.items()}
        q = ref.calibrate(w32, group, calib)
        return (lambda x: ref.forward_int8(q, group, x)), q
    return (lambda x: ref.forward_float(weights, group, x)), None


def widest_by_map(gaps) -> Dict[str, float]:
    """Per map, its widest gap over the compared images."""
    out: Dict[str, float] = {}
    for g in gaps:
        for k, v in g.items():
            out[k] = max(out.get(k, 0.0), v)
    return out
