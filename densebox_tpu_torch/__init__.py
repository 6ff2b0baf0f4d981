"""densebox_tpu_torch — the DenseBox detector on PyTorch and CUDA (NVIDIA H100).

A port of ``densebox_tpu`` (JAX/Pallas), which stays beside it as the
reference every module here is tested against. This package imports torch
and never jax, and nothing of the JAX package: it keeps its own copies of
the config tree (config.py) and the presets (presets.py), with the same
field names and defaults, so a config dict of either package loads in the
other. Entry points run on a CUDA card unless the caller names another
device (device.py).

Slices covered so far: the float (f32/bf16) and the int8 post-training
quantised detect-and-serve paths, with and without landmarks and the refine
branch — model forwards (models/, the int8 one on hand-written CUDA
int8-conv and requant kernels), fixed-K decode, greedy NMS and the landmark
window gather (ops/, with hand-written CUDA NMS and window kernels; the
kernel sources are under csrc/), the image pyramid and landmark decode
(infer/) and the request-coalescing server (serve.py) — and the train step:
GT rasterization and OHEM selection on hand-written CUDA kernels
(ops/labels.py, ops/ohem.py), the train-mode forward with the fused
relu+dropout, on-device patch sampling and synthetic data (data/), the SGD
step (train/loop.py) and the trainer around it: ``fit`` with checkpoints,
exact resume and the divergence check (train/trainer.py,
train/checkpoint.py), metric logging (utils/logging.py). See ROADMAP.md for
the slices to come.

Public functions take and return the JAX package's layouts: NHWC images and
maps, (B, K, 4) xyxy boxes.
"""

__version__ = "0.1.0"

from densebox_tpu_torch.config import (  # noqa: F401
    DenseBoxConfig,
    InferCfg,
    LabelCfg,
    LossCfg,
    ModelCfg,
    TrainCfg,
    resolved_canvas_dtype,
)
from densebox_tpu_torch.device import resolve_device  # noqa: F401
from densebox_tpu_torch.presets import kitti_vehicle, malf_face  # noqa: F401
from densebox_tpu_torch.models import (  # noqa: F401
    DenseBox,
    QuantDenseBox,
    from_flax,
    init_params,
    qparams_from_jax,
    state_from_jax,
    quantize_densebox,
)
