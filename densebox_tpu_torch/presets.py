"""Application presets: KITTI-style vehicle detection and MALF face
detection with landmarks (paper §4-5). The port's own copy of
``densebox_tpu/presets.py``; both return equal config dicts.
"""

from __future__ import annotations

from densebox_tpu_torch.config import (DenseBoxConfig, InferCfg, LabelCfg,
                                       LossCfg, ModelCfg, TrainCfg)


def kitti_vehicle(width_mult: float = 1.0, fast: bool = False
                  ) -> DenseBoxConfig:
    """Vehicle detection, KITTI-style boxes, no landmarks. Paper patch
    geometry: 240 px patches, 50 px standard height, stride 4."""
    return DenseBoxConfig(
        model=ModelCfg(num_landmarks=0, use_refine=False,
                       width_mult=width_mult,
                       stem="s2d" if fast else "conv",
                       trunk_depth=3 if fast else 4),
        label=LabelCfg(patch_size=240, std_height_px=50.0),
        loss=LossCfg(),
        infer=InferCfg(scales=(0.5, 0.7071, 1.0, 1.4142)),
        train=TrainCfg(batch_size=32, max_boxes=16),
    )


def malf_face(num_landmarks: int = 5, width_mult: float = 1.0,
              fast: bool = False) -> DenseBoxConfig:
    """Face detection with per-landmark heatmaps and the refinement branch
    (paper §4; the landmark count is a knob). Faces are near-square, so the
    default pyramid is denser at small scales."""
    # 5-point flip permutation: left eye <-> right eye, nose fixed,
    # mouth-left <-> mouth-right (only defined for the 5-point layout)
    perm = (1, 0, 2, 4, 3) if num_landmarks == 5 else None
    # canonical box-relative 5-point layout (eyes, nose, mouth corners)
    anchors = ((0.30, 0.38), (0.70, 0.38), (0.50, 0.55),
               (0.35, 0.75), (0.65, 0.75)) if num_landmarks == 5 else None
    return DenseBoxConfig(
        model=ModelCfg(num_landmarks=num_landmarks, use_refine=True,
                       width_mult=width_mult,
                       stem="s2d" if fast else "conv",
                       trunk_depth=3 if fast else 4),
        label=LabelCfg(patch_size=240, std_height_px=50.0,
                       lm_flip_perm=perm, lm_anchors=anchors),
        loss=LossCfg(lambda_lm=1.0, lambda_refine=1.0),
        infer=InferCfg(scales=(0.3536, 0.5, 0.7071, 1.0, 1.4142)),
        train=TrainCfg(batch_size=32, max_boxes=16),
    )
