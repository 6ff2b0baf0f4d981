"""Export of the detect pipeline as one self-contained artifact (port of
``densebox_tpu/export.py``).

``export_detect_program`` traces the whole of ``detect_batch`` (forward at
every pyramid scale, decode, NMS, landmark decode) with ``torch.export``
(non-strict, under ``torch.no_grad()``) at a fixed input contract,
``(batch, H, W, 3) float32 RGB in [0, 1]`` on one device, with the weights
baked in as the program's parameters and buffers. The four kernels of the
path are the custom operators ``densebox::greedy_keep``, ``qconv_int8``,
``requant_epilogue`` and ``gather_windows`` (``ops/kernels/``): each is one
opaque node of the program, so the program launches the hand-written
kernels when it runs on the card and never holds their plain versions.

Format: ``MAGIC``, one strict-JSON metadata line (the input contract and
provenance: batch, canvas, quantized, backend, landmarks, scales, input,
device, torch), then the ``torch.export.save`` payload. ``load_exported``
returns a callable with ``make_detect_fn``'s signature and outputs; loading
needs torch and the operator registrations of ``ops/kernels/`` (imported by
this module), not the checkpoint, the config or the model code.

The program is traced for the device it was exported on (``ops/decode.py``
divides by a number differently on the card than on the CPU), so a load on
another device is refused: re-export there. A program saved by one torch
version is read by that version: make and load artifacts with one install.
No counterpart of JAX's ``platforms``: ``device`` takes its place.
"""

from __future__ import annotations

import io
import json
import warnings
from typing import Any, Dict, Tuple

import torch
from torch import nn

from densebox_tpu_torch.device import resolve_device
from densebox_tpu_torch.infer.detector import detect_batch
# importing the kernel modules registers the program's custom operators
from densebox_tpu_torch.ops.kernels import (  # noqa: F401
    nms, qconv, requant, window)

MAGIC = b"DENSEBOX_TORCH_EXPORT_V1\n"


class DetectProgram(nn.Module):
    """``detect_batch`` of ``model`` with fixed configs, as the module that
    ``torch.export`` traces."""

    def __init__(self, model: nn.Module, infer_cfg, label_cfg):
        super().__init__()
        self.model = model
        self.infer_cfg = infer_cfg
        self.label_cfg = label_cfg

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detect_batch(self.model, images, self.infer_cfg,
                            self.label_cfg)


def _card(device) -> torch.device:
    """``device`` with a CUDA index filled in (``cuda`` -> ``cuda:<n>``, the
    current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def export_detect_program(model: nn.Module, infer_cfg, label_cfg,
                          batch: int, canvas_hw: Tuple[int, int],
                          device=None) -> torch.export.ExportedProgram:
    """Trace the detect pipeline of ``model`` (``DenseBox`` or
    ``QuantDenseBox``, moved to ``device``: the card when none is given)
    for ``(batch, H, W, 3)`` float32 images and return the
    ``ExportedProgram``. The pipeline runs once on a zero batch first, so
    that the constants the live path keeps (resize and upsample weights,
    the int8 epilogue vectors) are the program's constants and not
    recomputed in it on every call."""
    dev = _card(resolve_device(device))
    model.to(dev).eval()
    h, w = canvas_hw
    images = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev)
    program = DetectProgram(model, infer_cfg, label_cfg).eval()
    with torch.no_grad():
        program(images)
        exported = torch.export.export(program, (images,), strict=False)
    # the zero batch is no part of the program (and would add its bytes,
    # 30 MB at B=8, 480 x 640, to every artifact)
    exported.example_inputs = None
    return exported


def artifact_meta(model: nn.Module, infer_cfg, batch: int,
                  canvas_hw: Tuple[int, int]) -> Dict[str, Any]:
    """The metadata line of an artifact of ``model``: its input contract and
    what it computes (``save_exported`` adds the device and torch's
    version)."""
    h, w = canvas_hw
    backend = getattr(model, "backend", None)
    return {"batch": batch, "canvas": [h, w],
            "quantized": backend is not None, "backend": backend,
            "landmarks": model.cfg.num_landmarks,
            "scales": list(infer_cfg.scales),
            "input": f"({batch}, {h}, {w}, 3) float32 RGB in [0, 1]"}


def program_device(exported: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's image input."""
    name, = exported.graph_signature.user_inputs
    node = next(n for n in exported.graph.nodes if n.name == name)
    return node.meta["val"].device


def save_exported(path: str, exported: torch.export.ExportedProgram,
                  meta: Dict[str, Any]) -> None:
    """MAGIC + one strict-JSON line (``meta`` with the program's device and
    torch's version) + the ``torch.export.save`` payload."""
    meta = dict(meta, device=str(program_device(exported)),
                torch=torch.__version__)
    payload = io.BytesIO()
    with warnings.catch_warnings():
        # the convs' channels_last weights are not "contiguous" to the
        # archive writer, which warns and then stores each one whole (its
        # own storage, with its strides)
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(exported, payload)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write((json.dumps(meta, allow_nan=False) + "\n").encode())
        f.write(payload.getvalue())


def load_exported(path: str, device=None):
    """Load an artifact: returns ``(call, meta)``, where ``call(images)``
    runs the baked pipeline on a ``(batch, H, W, 3)`` float32 batch of the
    exported contract, on ``device`` (the card when none is given), and
    returns the detections dict of ``make_detect_fn``. Raises if the
    artifact was exported for another device."""
    dev = _card(resolve_device(device))
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a densebox_tpu_torch export "
                             f"artifact")
        meta = json.loads(f.readline().decode())
        payload = f.read()
    if torch.device(meta["device"]) != dev:
        raise ValueError(
            f"{path} was exported for {meta['device']} and cannot run on "
            f"{dev}: re-export it there (cli export --device {dev})")
    module = torch.export.load(io.BytesIO(payload)).module()

    @torch.inference_mode()
    def call(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return module(images)

    return call, meta
