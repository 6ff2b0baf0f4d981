"""Metrics logging, profiling and debug checks (port of
``densebox_tpu/utils/logging.py``).

Per-step metric dicts go to the console, and to TensorBoard scalars when a
log directory is given and ``tensorboardX`` imports (it is imported only
then, and ``tensorflow`` never is). ``maybe_profile`` traces a window with
``torch.profiler`` into a Chrome trace file, and ``enable_debug_checks``
turns on autograd's anomaly detection (a backward that produces NaN raises
and names the forward op), the counterparts of jax's profiler trace and its
NaN-check flag.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Mapping, Optional

import torch


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


@contextlib.contextmanager
def maybe_profile(logdir: Optional[str]):
    """Trace the window with ``torch.profiler`` (host and, where there is a
    card, device activity) and write ``<logdir>/trace_<pid>.json``, a Chrome
    trace that TensorBoard's profile plugin and Perfetto read. No-op for an
    empty ``logdir``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"wrote profiler trace {path}", flush=True)


def enable_debug_checks() -> None:
    """Debug mode: autograd anomaly detection for the rest of the process.
    A backward that produces NaN raises, with the traceback of the forward
    op that made it; every backward runs slower. The trainer's boundary
    check (``TrainingDiverged``) stays on either way."""
    torch.autograd.set_detect_anomaly(True)
