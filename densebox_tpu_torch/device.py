"""Which device an entry point of the port runs on.

The port is written for the card: an entry point given no device runs on
CUDA, and raises when there is no card rather than carrying on on the CPU.
The CPU (the tests' device) is taken only when the caller names it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, raising when no CUDA card is
    available; anything else (a ``torch.device`` or a string such as "cpu",
    "cuda:1", "meta") is passed through as a ``torch.device``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "densebox_tpu_torch runs on a CUDA card by default and "
            "torch.cuda.is_available() is false; pass device=\"cpu\" to run "
            "on the CPU")
    return torch.device("cuda")
