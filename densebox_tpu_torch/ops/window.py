"""Windowed heatmap gather (counterpart of ``densebox_tpu/ops/window.py``).

The JAX package dispatches between its Pallas kernel and a vmapped
``dynamic_slice`` twin by a ``backend`` argument. Here the tensor's device
decides: ``ops.kernels.window.gather_windows`` launches the CUDA kernel on
the card and runs its plain version on the CPU. The JAX package's
``lm_backend`` and ``lm_window_dp`` are TPU policies; the port reads
neither.
"""

from densebox_tpu_torch.ops.kernels.window import (  # noqa: F401
    gather_windows,
    gather_windows_reference,
)
