"""The numbers that decide ``correct``, each held to its limit.

* ``scale_gap``: the widest relative gap between the program's int8 scales
  (every conv's input scale and per-channel weight scale) and those the
  reference calibrates from the same weights and images.
* ``map_gap``: the widest relative L2 gap, over compared images, pyramid
  levels and maps, between the program's maps and the reference's own
  forward of the same image: ``||program - reference|| / ||reference||``.
* ``det_gap``: the widest absolute gap between an answer (boxes, scores
  and landmark points of the valid detections) and the reference's
  detections from the same maps; ``SETS_DIFFER`` where the two disagree on
  which slots or landmarks are valid.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

SETS_DIFFER = 1e6


def scale_gap(program: Dict[str, torch.Tensor],
              reference: Dict[str, Dict[str, torch.Tensor]]) -> float:
    """``program`` holds ``<conv>.in_scale`` and ``<conv>.w_scale``."""
    worst = 0.0
    for name, q in reference.items():
        for key in ("in_scale", "w_scale"):
            p = program[f"{name}.{key}"].double().cpu()
            r = q[key].double().cpu()
            worst = max(worst, float(((p - r).abs() / r).max()))
    return worst


def map_gaps(program: List[Dict[str, torch.Tensor]],
             reference: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Per map (``score``, ``loc``...), its widest relative L2 gap over the
    levels. ``program`` and ``reference`` hold a dict of (1, h, w, C) maps
    of one image per level."""
    out: Dict[str, float] = {}
    for p_lv, r_lv in zip(program, reference, strict=True):
        for key, r in r_lv.items():
            r = r.double()
            d = (p_lv[key].to(r.device).double() - r).norm()
            g = float(d / r.norm().clamp_min(1e-30))
            out[key] = max(out.get(key, 0.0), g)
    return out


def map_gap(program: List[Dict[str, torch.Tensor]],
            reference: List[Dict[str, torch.Tensor]]) -> float:
    return max(map_gaps(program, reference).values())


def answer(dets: Dict[str, torch.Tensor], i: int, f: float = 1.0
           ) -> Dict[str, np.ndarray]:
    """Image ``i``'s valid detections in its own coordinates (a request
    letterboxed by ``f``), as the server answers."""
    v = dets["valid"][i].cpu().numpy()
    out = {"boxes": dets["boxes"][i].cpu().numpy()[v] / f,
           "scores": dets["scores"][i].cpu().numpy()[v]}
    if "lm_points" in dets:
        out["lm_points"] = dets["lm_points"][i].cpu().numpy()[v] / f
        out["lm_valid"] = dets["lm_valid"][i].cpu().numpy()[v]
    return out


def det_gap(pairs: Iterable[Tuple[Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]]) -> float:
    """(answer, reference answer) pairs -> the widest gap."""
    worst = 0.0
    for got, want in pairs:
        if got["scores"].shape != want["scores"].shape or (
                "lm_valid" in want
                and not np.array_equal(got["lm_valid"], want["lm_valid"])):
            return SETS_DIFFER
        for key in ("boxes", "scores", "lm_points"):
            if key in want and want[key].size:
                d = np.abs(got[key].astype(np.float64)
                           - want[key].astype(np.float64))
                worst = max(worst, float(d.max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Every number at or under its limit -> (correct, checks); a number
    that is not finite (nothing to compare) fails and shows as None."""
    ok = bool(numbers) and all(np.isfinite(v) and v <= limits[k]
                               for k, v in numbers.items())
    checks = {k: {"value": float(v) if np.isfinite(v) else None,
                  "limit": limits[k]} for k, v in numbers.items()}
    return ok, checks
