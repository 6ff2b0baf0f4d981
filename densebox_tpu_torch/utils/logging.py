"""Metrics logging (port of ``densebox_tpu/utils/logging.py:MetricsLogger``).

Per-step metric dicts go to the console, and to TensorBoard scalars when a
log directory is given and ``tensorboardX`` imports (it is imported only
then, and ``tensorflow`` never is). The JAX package's ``maybe_profile`` and
``enable_debug_checks`` wrap jax's profiler and its NaN-check flag and have
no counterpart here: ``torch.profiler`` is used directly where a trace is
wanted (``profile_port.py``), and ``TrainingDiverged`` is the trainer's
check for non-finite values.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional


def _summary_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter
    except Exception:           # no writer installed: console only
        return None
    return SummaryWriter(logdir)


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None):
        self._writer = _summary_writer(logdir) if logdir else None
        self._t_last = time.perf_counter()
        self._step_last = 0

    def log(self, step: int, metrics: Mapping, prefix: str = "train"
            ) -> Dict[str, float]:
        """Print ``[prefix step N] k=v ...`` (sorted keys, with
        ``steps_per_sec`` since the last call) and return the values as
        floats. Reading a metric that is a tensor on the card waits for the
        card, so call this at log boundaries only."""
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        if step > self._step_last:
            vals["steps_per_sec"] = ((step - self._step_last) /
                                     max(now - self._t_last, 1e-9))
        self._t_last, self._step_last = now, step
        if self._writer is not None:
            for k, v in vals.items():
                self._writer.add_scalar(f"{prefix}/{k}", v, step)
            self._writer.flush()
        msg = " ".join(f"{k}={v:.4g}" for k, v in sorted(vals.items()))
        print(f"[{prefix} step {step}] {msg}", flush=True)
        return vals

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
