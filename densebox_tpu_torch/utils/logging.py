"""Metrics logging, profiling and debug checks (port of
``densebox_tpu/utils/logging.py``).

Per-step metric dicts go to the console, and to TensorBoard scalars when a
log directory is given and ``tensorboardX`` imports (it is imported only
then, and ``tensorflow`` never is). ``maybe_profile`` traces a window with
``torch.profiler`` into a Chrome trace file, and ``enable_debug_checks``
turns on autograd's anomaly detection (a backward that produces NaN raises
and names the forward op), the counterparts of jax's profiler trace and its
NaN-check flag.

Spans: ``record_span`` keeps ``(name, start_ns, end_ns, id, parent)`` in one
process-wide ring of the last ``SPAN_RING`` spans, always on (two clock
reads and a locked append a span: no exporter, no file, no switch).
``spans_between`` reads the spans that overlap a window and
``spans_dropped`` says whether the ring lost any. ``span`` records a block
under the id that the innermost ``spans_under`` names (``detect_batch``
names its call's id, so the model's spans inside it nest there). The clock is
``time.time_ns()``, which is also ``torch.profiler``'s host clock (Unix
epoch ns), so a span lines up with a profiler trace as it is. Spans take
no ``torch.profiler`` annotation: on CUDA every ``record_function`` range
gets a device-side twin that a trace counts as device work, and the
profiler sees only the thread that started it.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

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


SPAN_RING = 65536          # a 51-s window of the malf serve cell: ~15k spans

Span = Tuple[str, int, int, Optional[int], Optional[int]]
_RING: "collections.deque[Span]" = collections.deque(maxlen=SPAN_RING)
_DROPPED = [0, 0]          # spans pushed out, the latest end_ns among them
_LOCK = threading.Lock()   # the drop count is a check-then-act on the ring
_IDS = itertools.count(1)


def new_span_id() -> int:
    """A process-wide unique span id (safe from any thread)."""
    return next(_IDS)


def record_span(name: str, start_ns: int, end_ns: int,
                id: Optional[int] = None, parent: Optional[int] = None
                ) -> None:
    """Keep one span, its times from ``time.time_ns()``. ``id`` ties the
    spans of one unit of work (a request, a device call) together and
    ``parent`` names the id it ran under. When the ring is full its oldest
    span is pushed out and counted. Safe from any thread."""
    with _LOCK:
        if len(_RING) == _RING.maxlen:
            _DROPPED[0] += 1
            _DROPPED[1] = max(_DROPPED[1], _RING[0][2])
        _RING.append((name, start_ns, end_ns, id, parent))


_PARENT: "contextvars.ContextVar[Optional[int]]" = contextvars.ContextVar(
    "densebox_span_parent", default=None)


@contextlib.contextmanager
def spans_under(parent: int):
    """``span`` blocks inside this one (in this thread or task) name
    ``parent`` as their parent."""
    token = _PARENT.set(parent)
    try:
        yield
    finally:
        _PARENT.reset(token)


@contextlib.contextmanager
def span(name: str):
    """Keep the block as a span on the host clock, under the innermost
    ``spans_under`` id (None outside one). It marks when the host issued
    the block's work; the card may run it later."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        record_span(name, t0, time.time_ns(), None, _PARENT.get())


def spans_between(lo_ns: int, hi_ns: int) -> List[Span]:
    """The ring's spans that overlap ``[lo_ns, hi_ns]``, oldest first."""
    with _LOCK:
        ring = _RING.copy()
    return [s for s in ring if s[2] >= lo_ns and s[1] <= hi_ns]


def spans_dropped(after_ns: Optional[int] = None) -> int:
    """How many spans the full ring has pushed out. With ``after_ns``, 0
    unless one of them ended after it: a window that starts at
    ``after_ns`` then still has all of its spans."""
    with _LOCK:
        n, last_end = _DROPPED
    return n if after_ns is None or last_end > after_ns else 0


def enable_debug_checks() -> None:
    """Debug mode: autograd anomaly detection for the rest of the process.
    A backward that produces NaN raises, with the traceback of the forward
    op that made it; every backward runs slower. The trainer's boundary
    check (``TrainingDiverged``) stays on either way."""
    torch.autograd.set_detect_anomaly(True)
