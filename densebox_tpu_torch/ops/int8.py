"""The float side of the int8 chain: the dtype of the float tensors between
int8 stages and the quantise of an activation to int8 codes, as the JAX
package's ``_GLUE`` and ``_quant_act`` (``densebox_tpu/models/quant.py``).
``models/quant.py`` and the plain version of ``ops/kernels/neck.py`` read
them."""

from __future__ import annotations

import torch

GLUE = torch.bfloat16   # dtype of the float tensors between int8 stages


def quant_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], int8 (a division, as JAX's
    ``_quant_act``: multiplying by the reciprocal would round differently)."""
    return torch.round(x.to(torch.float32) / scale).clamp(-127, 127).to(
        torch.int8)
