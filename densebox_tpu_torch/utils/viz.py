"""Result visualization (port of ``densebox_tpu/utils/viz.py``): draw
detections and landmarks, write result images. Host-side and cv2-based; cv2
is imported inside the functions, so callers on a machine without it can
test for ImportError."""

from __future__ import annotations

from typing import Dict

import numpy as np

_BOX = (0, 220, 90)
_LM = (60, 120, 255)


def draw_detections(image_rgb: np.ndarray, dets: Dict[str, np.ndarray],
                    batch_index: int = 0,
                    score_fmt: str = "{:.2f}") -> np.ndarray:
    """Render one image's detections dict (as returned by detect_batch,
    converted to numpy). Returns an RGB uint8 copy."""
    import cv2

    img = image_rgb.copy()
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    boxes = np.asarray(dets["boxes"][batch_index])
    scores = np.asarray(dets["scores"][batch_index])
    valid = np.asarray(dets["valid"][batch_index])
    lms = dets.get("lm_points")
    for i in np.nonzero(valid)[0]:
        x1, y1, x2, y2 = boxes[i].astype(int)
        cv2.rectangle(img, (x1, y1), (x2, y2), _BOX, 2)
        cv2.putText(img, score_fmt.format(float(scores[i])), (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.45, _BOX, 1, cv2.LINE_AA)
        if lms is not None:
            lm_ok = dets.get("lm_valid")
            pts = np.asarray(lms[batch_index][i]).astype(int)
            for li, (px, py) in enumerate(pts):
                # filled dot = real decode; hollow = centre fallback
                # (lm_valid bit from decode_landmarks_selected)
                filled = lm_ok is None or bool(
                    np.asarray(lm_ok[batch_index][i][li]))
                cv2.circle(img, (px, py), 2, _LM, -1 if filled else 1)
    return img


def save_image(path: str, image_rgb: np.ndarray) -> None:
    import cv2

    cv2.imwrite(path, cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR))
