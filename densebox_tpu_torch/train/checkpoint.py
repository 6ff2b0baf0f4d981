"""Checkpoints and resume (port of ``densebox_tpu/train/checkpoint.py``).

A training checkpoint is one file a step, ``<ckpt_dir>/step_<N>.pt``:
``torch.save`` of the parameters and the momentum trace (tensors moved to
the CPU), the step count, the seed and salt of the per-step random draws
(``train/loop.py:step_seed``: a step's draws depend on nothing else, so no
generator state is stored) and the config as a JSON string. A file is
written under a temporary name in the same directory and renamed, so a
reader never sees half a file; ``keep`` newest steps stay. Files are loaded
with ``torch.load(..., weights_only=True)``. Saves are synchronous: when
``save_checkpoint`` returns the file is in place.

An int8 export (``save_quantized``) is a directory with one such file
holding ``QuantDenseBox``'s buffers and the marker ``quantized.json``.
Orbax checkpoint directories of the JAX package are not read.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from densebox_tpu_torch.config import DenseBoxConfig
from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.train.loop import TrainState

FORMAT = 1
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_QUANT_MARKER = "quantized.json"


class CheckpointManager:
    """The step files of one directory: the newest ``keep`` are kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.directory = os.path.abspath(ckpt_dir)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        """Steps with a finished file, ascending (a leftover temporary file
        of an interrupted save does not count)."""
        found = (_STEP_FILE.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, payload: Dict) -> None:
        tmp = os.path.join(self.directory, f".step_{step:08d}.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        if self.keep > 0:
            for old in self.all_steps()[:-self.keep]:
                os.remove(self.path(old))

    def load(self, step: int) -> Dict:
        payload = torch.load(self.path(step), map_location="cpu",
                             weights_only=True)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{self.path(step)}: unknown checkpoint format "
                             f"{payload.get('format')!r}")
        return payload

    def wait_until_finished(self) -> None:
        """Nothing to wait for: ``save`` returns with the file in place."""


def make_manager(ckpt_dir: str, keep: int = 3) -> CheckpointManager:
    return CheckpointManager(ckpt_dir, keep)


def _cpu(tensors) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tensors.items()}


def save_checkpoint(mngr: CheckpointManager, state: TrainState,
                    cfg: DenseBoxConfig) -> None:
    mngr.save(state.step, {
        "format": FORMAT, "step": state.step, "seed": state.seed,
        "salt": state.salt, "params": _cpu(state.model.state_dict()),
        "momentum": _cpu(state.momentum),
        "config": json.dumps(cfg.to_dict())})


def restore_checkpoint(mngr: CheckpointManager, template: TrainState,
                       device=None
                       ) -> Optional[Tuple[TrainState, DenseBoxConfig]]:
    """Load the latest checkpoint into ``template`` (a freshly created state
    whose model is on ``device``: the card when none is given) and return it
    with the stored config, or None if the directory holds no checkpoint."""
    dev = resolve_device(device)
    step = mngr.latest_step()
    if step is None:
        return None
    if any(p.device.type != dev.type for p in template.model.parameters()):
        raise ValueError(f"restore_checkpoint: the template's model is not "
                         f"on {dev}")
    payload = mngr.load(step)
    template.load(payload["params"], payload["momentum"], payload["step"])
    template.seed, template.salt = payload["seed"], payload["salt"]
    return template, DenseBoxConfig.from_dict(json.loads(payload["config"]))


def load_for_inference(ckpt_dir: str, device=None
                       ) -> Tuple[DenseBoxConfig, Dict[str, torch.Tensor]]:
    """(config, ``state_dict`` on ``device``: the card when none is given)
    of the latest checkpoint, for ``DenseBox(cfg.model).load_state_dict``."""
    dev = resolve_device(device)
    mngr = _existing(ckpt_dir)
    payload = mngr.load(mngr.latest_step())
    return (DenseBoxConfig.from_dict(json.loads(payload["config"])),
            {k: v.to(dev) for k, v in payload["params"].items()})


def _existing(ckpt_dir: str) -> CheckpointManager:
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    mngr = CheckpointManager(ckpt_dir, keep=0)
    if mngr.latest_step() is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return mngr


def save_quantized(ckpt_dir: str, qparams, cfg: DenseBoxConfig,
                   calibration: str = "") -> None:
    """Export an int8-PTQ checkpoint: ``qparams`` (the ``state_dict`` of a
    ``QuantDenseBox``), the config and a marker recording the calibration
    source, so that detect and serve load it instead of recalibrating.
    Exporting again over an earlier export replaces it; a directory that
    holds a training run's checkpoints is refused."""
    if is_quantized_dir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    elif os.path.isdir(ckpt_dir) and CheckpointManager(
            ckpt_dir, keep=0).latest_step() is not None:
        raise FileExistsError(f"{ckpt_dir} holds checkpoints that are not an "
                              f"int8 export; not overwriting them")
    CheckpointManager(ckpt_dir, keep=1).save(0, {
        "format": FORMAT, "qparams": _cpu(qparams),
        "config": json.dumps(cfg.to_dict())})
    with open(os.path.join(ckpt_dir, _QUANT_MARKER), "w") as f:
        json.dump({"format": FORMAT, "calibration": calibration}, f)


def is_quantized_dir(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, _QUANT_MARKER))


def load_quantized(ckpt_dir: str, device=None
                   ) -> Tuple[DenseBoxConfig, Dict[str, torch.Tensor], str]:
    """(config, qparams on ``device``: the card when none is given,
    calibration note) of a ``save_quantized`` export."""
    dev = resolve_device(device)
    mngr = _existing(ckpt_dir)
    payload = mngr.load(mngr.latest_step())
    with open(os.path.join(ckpt_dir, _QUANT_MARKER)) as f:
        meta = json.load(f)
    return (DenseBoxConfig.from_dict(json.loads(payload["config"])),
            {k: v.to(dev) for k, v in payload["qparams"].items()},
            meta.get("calibration", ""))
