"""Which device an entry point of the port runs on, and at what precision.

The port is written for the card: an entry point given no device runs on
CUDA, and raises when there is no card rather than carrying on on the CPU.
The CPU (the tests' device) is taken only when the caller names it.

The JAX reference computes float32 at ``lax.Precision.HIGHEST``, while
torch lets cuDNN's float32 convolutions run on TF32 by default, and cuBLAS
may reduce a bfloat16 product in reduced precision. ``reference_precision``
turns these off where the reference's precision applies; the port's
forwards, train steps, resizes and artifacts enter it themselves.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

# torch's process-wide switches of how cuDNN and cuBLAS round float32 and
# bfloat16 products, as (owner, attribute)
_SWITCHES = {
    "cudnn_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "bf16_reduction": (torch.backends.cuda.matmul,
                       "allow_bf16_reduced_precision_reduction"),
}
# the value of each switch inside ``reference_precision``
REFERENCE = dict.fromkeys(_SWITCHES, False)

# per switch: how many ``reference_precision`` blocks hold it now, and its
# value before the first of them came in
_lock = threading.Lock()
_depth = dict.fromkeys(_SWITCHES, 0)
_saved: Dict[str, bool] = {}


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


def device_name(device: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    else the device as written ("cpu"): what a measurement names as the
    device it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def precision_flags() -> Dict[str, bool]:
    """The switches' values now, by name (``cudnn_tf32``, ``matmul_tf32``,
    ``bf16_reduction``)."""
    return {name: getattr(owner, attr)
            for name, (owner, attr) in _SWITCHES.items()}


def _held(compute_dtype, int8_chain: bool):
    if isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    names = []
    if compute_dtype == torch.float32:
        names += ["cudnn_tf32", "matmul_tf32"]
    if int8_chain:
        names.append("bf16_reduction")
    return names


@contextlib.contextmanager
def reference_precision(compute_dtype, int8_chain: bool = False):
    """Within it the card computes as the reference does: for float32
    ``compute_dtype`` (a dtype or its name) cuDNN's convolutions and
    cuBLAS's products run in full float32, not TF32; around the int8 chain
    (``int8_chain``) cuBLAS may not reduce a bfloat16 product in reduced
    precision, as the reference reduces in float32. (The chain's one such
    product, the x2 upsample, is taken in float32 outright,
    ``ops/upsample.py:interp_bmm``: cuBLAS's bfloat16 GEMM rounds rare
    elements otherwise with this switch either way.) Under bfloat16
    compute TF32 is left as it is: the reference's ``Precision.DEFAULT`` is
    the fast path.

    The switches are the process's. Each has its own depth count under a
    lock: the first block to hold it saves and sets it, the last one out
    puts it back, also when the block raises. So an f32 trainer and an int8
    server in two threads leave every switch as they found it; cuDNN and
    cuBLAS work of other threads runs with a held switch while it is held.
    A function may also be decorated with it."""
    names = _held(compute_dtype, int8_chain)
    if not names:
        yield
        return
    with _lock:
        for name in names:
            if _depth[name] == 0:
                owner, attr = _SWITCHES[name]
                _saved[name] = getattr(owner, attr)
                setattr(owner, attr, REFERENCE[name])
            _depth[name] += 1
    try:
        yield
    finally:
        with _lock:
            for name in names:
                _depth[name] -= 1
                if _depth[name] == 0:
                    owner, attr = _SWITCHES[name]
                    setattr(owner, attr, _saved.pop(name))
