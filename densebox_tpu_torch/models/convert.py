"""Weights for the port's DenseBox: from a Flax param tree, or fresh; a
whole train state from the JAX package's; and the int8 model's state from
the JAX package's qparams.

``from_flax`` maps the JAX model's parameter tree onto the port's
``state_dict``: the same names with '.' for '/' (``det/det_conv1`` ->
``det.det_conv1``), kernels HWIO -> OIHW, ``kernel`` -> ``weight``.
Fused and separate heads share one parameter layout in the JAX package, so
one mapping serves checkpoints of either.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from densebox_tpu_torch.config import ModelCfg
from densebox_tpu_torch.models.densebox import DenseBox
from densebox_tpu_torch.models.quant import QuantDenseBox

# std of a unit normal truncated to [-2, 2]: flax's he_normal divides by it
# so that the truncated draw keeps variance 2 / fan_in
_TRUNC_STD = 0.87962566103423978


def _expected(cfg: ModelCfg) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in
            DenseBox(cfg, device="meta").state_dict().items()}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _check_matches(sd: Dict[str, torch.Tensor], want: Dict[str, torch.Size],
                   what: str) -> None:
    if set(sd) != set(want):
        raise ValueError(
            f"{what} does not match the config: missing "
            f"{sorted(set(want) - set(sd))}, extra {sorted(set(sd) - set(want))}")
    for k, shape in want.items():
        if sd[k].shape != shape:
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} in the {what}, "
                             f"{tuple(shape)} for the config")


def from_flax(params: Mapping, cfg: ModelCfg) -> Dict[str, torch.Tensor]:
    """Flax params (``{'params': {...}}`` or the inner tree; numpy or any
    array ``np.asarray`` takes) -> a float32 ``state_dict`` for
    ``DenseBox(cfg)``. Raises if names or shapes do not match the config."""
    if "params" in params:
        params = params["params"]
    sd = {}
    for name, arr in _flatten(params).items():
        stem, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{stem}.weight"] = torch.from_numpy(
                np.array(np.transpose(arr, (3, 2, 0, 1)), np.float32))
        elif leaf == "bias":
            sd[f"{stem}.bias"] = torch.from_numpy(np.array(arr, np.float32))
        else:
            raise ValueError(f"unexpected Flax leaf {name!r}")
    _check_matches(sd, _expected(cfg), "Flax tree")
    return sd


def state_from_jax(params: Mapping, trace: Mapping, step, cfg: ModelCfg
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor], int]:
    """A JAX train state as numpy -> what ``train.loop.TrainState.load``
    takes: ``params`` (the Flax tree) and ``trace`` (the optax SGD momentum
    trace, a tree of the same structure) both become float32 dicts with the
    model's parameter names (kernels and their traces HWIO -> OIHW, exactly
    as ``from_flax``), ``step`` (the optimizer's count) an int."""
    return from_flax(params, cfg), from_flax(trace, cfg), int(step)


def qparams_from_jax(qparams: Mapping, cfg: ModelCfg
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 qparams (``quantize_densebox``'s tree; numpy
    or any array ``np.asarray`` takes) -> the ``state_dict`` of
    ``QuantDenseBox(cfg)``: names with '.' for '/', ``w_q`` HWIO -> the
    kernel's (Cout, k, k, Cin) int8, ``w_scale``, ``in_scale``, ``bias`` and
    ``f4_scale`` float32. Raises if names or shapes do not match the
    config."""
    sd = {}
    for name, arr in _flatten(qparams).items():
        name = name.replace("/", ".")
        if name.endswith(".w_q"):
            sd[name] = torch.from_numpy(
                np.array(np.transpose(arr, (3, 0, 1, 2)), np.int8))
        else:
            sd[name] = torch.from_numpy(np.array(arr, np.float32))
    want = {k: v.shape for k, v in
            QuantDenseBox(cfg, device="meta").state_dict().items()}
    _check_matches(sd, want, "qparams tree")
    return sd


def init_params(cfg: ModelCfg, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Fresh float32 ``state_dict``: He-normal kernels (a normal truncated
    at two standard deviations, scaled to variance 2 / fan_in, as flax's
    ``he_normal``) and zero biases, drawn from ``generator`` in the order of
    the state_dict. Not the JAX package's draws: those come from jax.random."""
    sd = {}
    for k, shape in _expected(cfg).items():
        t = torch.zeros(shape, dtype=torch.float32)
        if k.endswith(".weight"):
            fan_in = shape[1] * shape[2] * shape[3]
            std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=generator)
        sd[k] = t
    return sd
