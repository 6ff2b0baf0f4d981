"""The weights a cell serves or trains, made on the device from the seed:
one normal draw for every kernel together, scaled per tensor to He's
variance 2 / fan_in, and the biases the configuration file ``assumed``
(zero, except where it names the output bias of a head: random kernels
give near-zero maps, so the loc head's bias sets a box size and the score
head's a share of pixels over the score threshold). Both the program and
the reference are handed these tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from port_bench.reference.model import conv_specs


def make_weights(model: dict, biases: Dict[str, float], seed: int,
                 device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """name -> tensor in the program's parameter names (``conv1_1.weight``,
    ``det.det_conv2.bias``, ...), OIHW kernels, in ``dtype``."""
    specs = conv_specs(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(c.cout * c.cin * c.k * c.k for c in specs)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for c in specs:
        n = c.cout * c.cin * c.k * c.k
        w = flat[at:at + n].view(c.cout, c.cin, c.k, c.k)
        at += n
        out[f"{c.name}.weight"] = (w * math.sqrt(2.0 / (c.cin * c.k * c.k))
                                   ).to(dtype)
        out[f"{c.name}.bias"] = torch.full((c.cout,), biases.get(c.name, 0.0),
                                           device=device, dtype=dtype)
    return out
