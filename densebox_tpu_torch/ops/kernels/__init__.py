"""Hand-written CUDA kernels (sources in densebox_tpu_torch/csrc), each with
its plain PyTorch version beside its wrapper and a launch counter."""

from typing import Dict


def _counted_modules():
    from densebox_tpu_torch.ops.kernels import (labels, neck, nms, ohem,
                                                qconv, requant, window)

    return {"nms": nms, "qconv": qconv, "requant": requant, "window": window,
            "labels": labels, "ohem": ohem, "neck": neck}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for mod in _counted_modules().values():
        mod.reset_launches()


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches since the last reset, by kernel name (the
    labels module counts its two kernels apart). Only a launch on the card
    counts: a CPU tensor runs the plain version."""
    out = {}
    for name, mod in _counted_modules().items():
        if isinstance(mod.launches, dict):
            out.update(mod.launches)
        else:
            out[name] = mod.launches
    return out
