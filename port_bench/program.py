"""The program under test, ``densebox_tpu_torch``, built as a cell states
it: its configuration, the model at the cell's precision with the
benchmark's weights (int8: calibrated by the program's own
``quantize_densebox``), and a hook that keeps a forward's maps for the
images whose answers are compared."""

from __future__ import annotations

from typing import List, Optional

import torch

# the model group's dtypes at each precision a cell may state
PRECISIONS = {"float32": ("float32", "float32"),
              "bfloat16": ("bfloat16", "bfloat16"),
              "int8": ("bfloat16", "float32")}


def model_group(cell) -> dict:
    """The configuration's ``model`` group at the cell's precision."""
    compute, params = PRECISIONS[cell.spec["precision"]]
    return dict(cell.config["config"]["model"], compute_dtype=compute,
                param_dtype=params)


def config(cell):
    from densebox_tpu_torch.config import DenseBoxConfig

    return DenseBoxConfig.from_dict(dict(cell.config["config"],
                                         model=model_group(cell)))


def detector(cell, cfg, weights, calib: Optional[torch.Tensor], device):
    """The float ``DenseBox`` with ``weights``, or at precision int8 the
    ``QuantDenseBox`` that ``quantize_densebox`` makes of them on
    ``calib``."""
    from densebox_tpu_torch.models import (DenseBox, QuantDenseBox,
                                           quantize_densebox)

    if cell.spec["precision"] != "int8":
        model = DenseBox(cfg.model, device=device)
        model.load_state_dict(weights)
        return model.eval()
    model = QuantDenseBox(cfg.model, backend=cell.spec["backend"],
                          device=device)
    model.load_state_dict(quantize_densebox(weights, cfg.model, calib))
    return model.eval()


def scales_of(model) -> dict:
    """``<conv>.in_scale`` and ``<conv>.w_scale`` of an int8 model."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith((".in_scale", ".w_scale"))}


class Capture:
    """Keeps, while ``rows`` is set, each forward's maps of those rows of
    the batch: one dict a pyramid level, in the order of the levels."""

    def __init__(self, model):
        self.rows: Optional[torch.Tensor] = None
        self.levels: List[dict] = []
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, inputs, out):
        if self.rows is not None:
            self.levels.append({k: v.index_select(0, self.rows).clone()
                                for k, v in out.items()})

    def take(self) -> List[dict]:
        out, self.levels, self.rows = self.levels, [], None
        return out
