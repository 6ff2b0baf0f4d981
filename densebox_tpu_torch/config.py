"""Frozen config tree of the port: every constant of the framework.

The port's own copy of ``densebox_tpu/config.py``: the same classes, field
names, defaults and order, so that a config dict written by either package
loads in the other (``to_dict`` / ``from_dict``). Values follow the DenseBox
paper (arXiv:1509.04874 §3). The JAX package grew a number of A/B knobs for
its TPU backends; the port implements each operation once, following the
resolved default, so it reads those fields, keeps them in the dict and
ignores them. They are marked "ignored by the port" below.

All dataclasses are frozen and hashable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


def _round_channels(c: float, multiple: int = 8) -> int:
    """Round a channel count to a multiple of 8 (at least 8)."""
    return max(multiple, int(round(c / multiple)) * multiple)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """VGG-FCN DenseBox architecture (paper §3.2, §4). ``width_mult`` scales
    every conv width (rounded to multiples of 8); 1.0 is the paper's model."""

    num_landmarks: int = 0          # N per-landmark heatmap channels (paper §4)
    use_refine: bool = False        # refinement branch fusing score+landmarks
    width_mult: float = 1.0         # trunk/head channel multiplier
    # stem 's2d': space-to-depth(2) replaces the full-resolution conv1 block
    # and pool1; 's2d4': space-to-depth(4), the whole trunk at the output
    # stride. trunk_depth 3: VGG16-style 3-conv conv3/conv4 blocks.
    stem: str = "conv"              # 'conv' (paper) | 's2d' | 's2d4'
    trunk_depth: int = 4            # convs per conv3/conv4 block (4 = VGG19)
    head_width: int = 512           # 1x1 conv width in det/loc/lm heads
    refine_width: int = 64          # conv width in the refinement branch
    skip_fusion: str = "auto"       # ignored by the port (always 'split': each
    # head conv1 is two sliced-weight products over f3 and the upsampled f4)
    dropout_rate: float = 0.5       # dropout between head convs (paper §3.2)
    dropout_impl: str = "auto"      # ignored by the port (always the fused
    # relu+dropout whose backward reads only its output; the keep mask comes
    # from random bytes where the rate is a multiple of 1/256)
    head_impl: str = "auto"         # ignored by the port (always 'fused': one
    # conv1 product over all heads, one block-diagonal conv2, one dropout draw)
    pool_impl: str = "auto"         # ignored by the port
    compute_dtype: str = "float32"  # 'bfloat16' for production inference
    param_dtype: str = "float32"

    # Architecture invariants (not knobs): 3 maxpools + one 2x skip-upsample
    # => output stride 4 (paper §3.2). Inputs must be divisible by 8.
    stride: int = 4
    min_divisor: int = 8

    def scaled(self, c: int) -> int:
        return _round_channels(c * self.width_mult)


@dataclasses.dataclass(frozen=True)
class LabelCfg:
    """Dense GT label-map geometry (paper §3.1). Radii and normalizers are in
    *map units* (output-grid pixels) unless suffixed ``_px`` (input pixels)."""

    stride: int = 4
    patch_size: int = 240           # training patch edge (px)
    rc_ratio: float = 0.3           # positive-disc radius = rc_ratio * box height
    rnear: float = 2.0              # gray-zone dilation around positives
    std_height_px: float = 50.0     # standard object height in a patch (px)
    scale_band: Tuple[float, float] = (0.8, 1.25)  # in-scale height band vs std
    # Landmark channel permutation under horizontal flip (left eye <-> right
    # eye ...): a mirror swaps identities, not only coordinates. None =
    # identity (flip-symmetric landmark sets, or hflip=False).
    lm_flip_perm: Optional[Tuple[int, ...]] = None
    # Box-relative expected landmark positions ((ax, ay) in [0,1]^2 per
    # channel). When set, the decode-time peak search of channel l is
    # restricted to a disc around its expected position. None = search the
    # whole (dilated) box.
    lm_anchors: Optional[Tuple[Tuple[float, float], ...]] = None
    lm_anchor_radius: float = 0.25  # search-disc radius, as a fraction of the
                                    # box diagonal

    @property
    def map_size(self) -> int:
        assert self.patch_size % self.stride == 0
        return self.patch_size // self.stride

    @property
    def loc_norm(self) -> float:
        """Regression normalizer: 50 px / stride 4 = 12.5 map units (paper §3.3)."""
        return self.std_height_px / self.stride

    @property
    def height_band_map(self) -> Tuple[float, float]:
        """In-scale box-height band in map units."""
        lo, hi = self.scale_band
        return (lo * self.std_height_px / self.stride,
                hi * self.std_height_px / self.stride)


@dataclasses.dataclass(frozen=True)
class LossCfg:
    """OHEM-masked multi-task L2 loss (paper §3.3)."""

    lambda_loc: float = 3.0         # loc-loss weight (paper §3.3)
    lambda_lm: float = 1.0          # landmark heatmap loss weight (paper §4)
    lambda_refine: float = 1.0      # refined-score loss weight (paper §4)
    neg_pos_ratio: float = 1.0      # #sampled negatives = ratio * #positives
    hard_frac: float = 0.5          # share of sampled negatives hardest-by-loss
    min_neg: int = 16               # negatives sampled when a patch has no positives
    backend: str = "auto"           # ignored by the port (always the
    # threshold-bisection selection: the CUDA kernel on the card, its plain
    # version on the CPU)


@dataclasses.dataclass(frozen=True)
class InferCfg:
    """Image-pyramid inference + decode + NMS (paper §2)."""

    scales: Tuple[float, ...] = (0.5, 0.7071, 1.0, 1.4142)  # pyramid scale factors
    score_thresh: float = 0.5
    nms_iou: float = 0.5
    topk_per_scale: int = 256       # fixed-shape candidate extraction
    max_dets: int = 128             # final detections after cross-scale NMS
    pre_nms_topk: int = 512         # cross-scale candidate cap before NMS
                                    # (greedy NMS is O(K^2)); 0 disables
    pad_multiple: int = 8           # input spatial padding granularity
    nms_backend: str = "auto"       # ignored by the port
    approx_topk: bool = False       # ignored by the port (exact top-k)
    lm_topk: int = 64               # decode landmarks for only the top-K
                                    # detections by score; lower slots get the
                                    # centre fallback with lm_valid=False.
                                    # 0 = all max_dets slots
    lm_dtype: str = "auto"          # landmark heatmap dtype through the window
                                    # gather and peak search: 'float32' |
                                    # 'bfloat16' | 'auto' (= 'bfloat16')
    lm_window_dp: int = 0           # ignored by the port
    lm_backend: str = "auto"        # ignored by the port
    lm_decode: str = "std"          # which pyramid scale's heatmap decodes a
                                    # detection's landmarks: 'std' (the scale
                                    # that brings its box closest to the
                                    # standard height) | 'source' (the scale it
                                    # was found at) | 'finest'


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    """Training loop (paper §3.4)."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay_steps: int = 20000
    lr_decay_rate: float = 0.5
    grad_clip_norm: float = 10.0   # global-norm gradient clip; 0 disables. The
    # initial multi-task L2 loss is large at production scale, so unclipped
    # SGD at lr >= 3e-3 goes non-finite within steps.
    num_steps: int = 100000
    max_boxes: int = 16             # padded per-patch box capacity
    seed: int = 0
    ckpt_every: int = 1000
    ckpt_keep: int = 3
    log_every: int = 50
    label_backend: str = "auto"     # ignored by the port (the CUDA rasterizer
    # on the card, its plain version on the CPU)
    rng_impl: str = "auto"          # ignored by the port
    remat: str = "auto"             # ignored by the port
    crop_dtype: str = "auto"        # patch-crop interpolation dtype:
    # 'float32' | 'bfloat16' | 'auto' (= follow model.compute_dtype)
    canvas_dtype: str = "auto"      # dtype the data pipeline delivers
    # canvases in ('float32' | 'bfloat16' | 'auto' = follow crop_dtype);
    # resolved where batches are made, not in the step


def resolved_canvas_dtype(cfg: "DenseBoxConfig") -> str:
    """'float32' | 'bfloat16' the pipeline should deliver canvases in.
    'auto' follows the chain canvas_dtype -> crop_dtype ->
    model.compute_dtype."""
    cd = cfg.train.canvas_dtype
    if cd == "auto":
        cd = cfg.train.crop_dtype
        if cd == "auto":
            cd = cfg.model.compute_dtype
    return "bfloat16" if cd == "bfloat16" else "float32"


@dataclasses.dataclass(frozen=True)
class DenseBoxConfig:
    """Root config bundling every subsystem."""

    model: ModelCfg = dataclasses.field(default_factory=ModelCfg)
    label: LabelCfg = dataclasses.field(default_factory=LabelCfg)
    loss: LossCfg = dataclasses.field(default_factory=LossCfg)
    infer: InferCfg = dataclasses.field(default_factory=InferCfg)
    train: TrainCfg = dataclasses.field(default_factory=TrainCfg)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DenseBoxConfig":
        def _tuples(v):
            # JSON gives lists, nested ones too (``lm_anchors``); the
            # fields hold tuples, so that configs compare and hash
            return tuple(_tuples(x) for x in v) if isinstance(v, list) else v

        def _mk(tp, sub):
            fields = {f.name for f in dataclasses.fields(tp)}
            return tp(**{k: _tuples(v) for k, v in sub.items()
                         if k in fields})

        return cls(
            model=_mk(ModelCfg, d.get("model", {})),
            label=_mk(LabelCfg, d.get("label", {})),
            loss=_mk(LossCfg, d.get("loss", {})),
            infer=_mk(InferCfg, d.get("infer", {})),
            train=_mk(TrainCfg, d.get("train", {})),
        )
