"""The canvas train step (port of ``densebox_tpu/train/trainer.py:
make_canvas_train_step``): on-device patch sampling, then the step of
``train/loop.py``. The long-running training loop (``fit``), checkpoints
and the divergence sentinel are not ported yet.
"""

from __future__ import annotations

from typing import Callable

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.models.densebox import DenseBox
from densebox_tpu_torch.train.loop import build_train_step


def make_canvas_train_step(model: DenseBox, cfg: DenseBoxConfig,
                           sample_from_canvas: bool = True, device=None
                           ) -> Callable:
    """As ``train.loop.make_train_step``, for batches of raw canvases (full
    images and boxes in canvas coordinates): each step first samples
    ``cfg.label.patch_size`` patches on the device
    (``data.patches.sample_patches``, interpolating in
    ``cfg.train.crop_dtype``), flips included. ``draws["patches"]`` gives
    that function's draws. With ``sample_from_canvas=False`` the batch is
    taken as pre-cropped patches."""
    return build_train_step(model, cfg, device, sample_from_canvas)
