"""KITTI-style annotation parsing (port of ``densebox_tpu/data/kitti.py``,
numpy only; the port keeps its own copy).

KITTI object-label format, one object per line:
  type truncated occluded alpha x1 y1 x2 y2 h w l X Y Z rot_y [score]
The type and 2D bbox columns are read. Images and labels pair by stem:
  <image_dir>/<stem>.(png|jpg|jpeg)  <->  <label_dir>/<stem>.txt

Keypoint extension (the framework's own): a ground-truth line may append
landmark coordinates after the 15 standard fields as flat
``lx1 ly1 lx2 ly2 ...`` pairs (an even count; the 16th "score" column only
exists in result files). Every annotated object in a dataset carries the
same landmark count L; objects without the extension get all-invisible
landmarks. A keypoint with either coordinate < 0 is invisible (excluded
from GT rasterization and NME).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

VEHICLE_CLASSES = ("Car", "Van", "Truck")
_IMG_EXTS = (".png", ".jpg", ".jpeg")
_N_STD_FIELDS = 15


@dataclasses.dataclass
class Sample:
    image_path: str
    boxes: np.ndarray        # (N, 4) xyxy float32, N >= 0
    landmarks: np.ndarray | None = None   # (N, L, 2) optional keypoints
                                          # (coords < 0 => invisible)
    truncation: np.ndarray | None = None  # (N,) float, KITTI col 2
    occlusion: np.ndarray | None = None   # (N,) int, KITTI col 3
    dontcare: np.ndarray | None = None    # (M, 4) xyxy 'DontCare' regions


def parse_label_file(
    path: str,
    classes: Sequence[str] = VEHICLE_CLASSES,
    num_landmarks: int = 0,
    return_meta: bool = False,
):
    """Parse one KITTI label txt -> ((N, 4) xyxy boxes, (N, L, 2) landmarks
    or None). With ``num_landmarks=0`` landmark columns are ignored.

    With ``return_meta=True`` additionally returns a dict with the
    per-object ``truncation`` (float) and ``occlusion`` (int) columns plus
    the file's ``dontcare`` regions — the fields the official KITTI eval
    protocol bins difficulties by (``eval.py:evaluate_kitti``). Malformed /
    pre-truncated fields parse as fully-visible (0.0 / 0)."""
    boxes: List[Tuple[float, float, float, float]] = []
    lms: List[np.ndarray] = []
    truncs: List[float] = []
    occs: List[int] = []
    dontcare: List[Tuple[float, float, float, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8:
                continue
            if parts[0] == "DontCare":
                dontcare.append(tuple(float(v) for v in parts[4:8]))
                continue
            if parts[0] not in classes:
                continue
            x1, y1, x2, y2 = (float(v) for v in parts[4:8])
            if not (x2 > x1 and y2 > y1):
                continue
            boxes.append((x1, y1, x2, y2))
            try:
                truncs.append(float(parts[1]))
                occs.append(int(float(parts[2])))
            except ValueError:
                truncs.append(0.0)
                occs.append(0)
            if num_landmarks:
                extra = [float(v) for v in parts[_N_STD_FIELDS:]]
                pts = np.full((num_landmarks, 2), -1.0, np.float32)
                n = min(len(extra) // 2, num_landmarks)
                if n:
                    pts[:n] = np.asarray(
                        extra[:2 * n], np.float32).reshape(n, 2)
                lms.append(pts)
    out_boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    out_lms = None
    if num_landmarks:
        out_lms = (np.stack(lms) if lms
                   else np.zeros((0, num_landmarks, 2), np.float32))
    if not return_meta:
        return out_boxes, out_lms
    meta = {
        "truncation": np.asarray(truncs, np.float32),
        "occlusion": np.asarray(occs, np.int32),
        "dontcare": np.asarray(dontcare, np.float32).reshape(-1, 4),
    }
    return out_boxes, out_lms, meta


def write_result_file(path: str, boxes: np.ndarray, scores: np.ndarray,
                      cls: str = "Car") -> None:
    """Write detections as a KITTI result txt (the format the official
    devkit consumes: the 15 standard fields with unknowns as -1/-1000 and
    the confidence score as the 16th column), which external KITTI tooling
    and ``eval.py:evaluate_kitti`` read."""
    lines = []
    for (x1, y1, x2, y2), s in zip(np.asarray(boxes, np.float64),
                                   np.asarray(scores, np.float64)):
        lines.append(
            f"{cls} -1 -1 -10 {x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
            f"-1 -1 -1 -1000 -1000 -1000 -10 {s:.4f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def load_dataset(image_dir: str, label_dir: str,
                 classes: Sequence[str] = VEHICLE_CLASSES,
                 num_landmarks: int = 0) -> List[Sample]:
    """Enumerate (image, label) pairs. Samples without any wanted-class box
    are kept (they become pure-negative patches, paper §3.4)."""
    samples: List[Sample] = []
    for name in sorted(os.listdir(label_dir)):
        if not name.endswith(".txt"):
            continue
        stem = name[:-4]
        img = next((os.path.join(image_dir, stem + ext)
                    for ext in _IMG_EXTS
                    if os.path.exists(os.path.join(image_dir, stem + ext))),
                   None)
        if img is None:
            continue
        boxes, lms, meta = parse_label_file(
            os.path.join(label_dir, name), classes, num_landmarks,
            return_meta=True)
        samples.append(Sample(image_path=img, boxes=boxes, landmarks=lms,
                              truncation=meta["truncation"],
                              occlusion=meta["occlusion"],
                              dontcare=meta["dontcare"]))
    if not samples:
        raise FileNotFoundError(
            f"no (image, label) pairs under {image_dir} / {label_dir}")
    return samples
