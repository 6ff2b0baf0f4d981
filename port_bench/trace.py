"""The traced run's window: ``torch.profiler`` over the measured window,
reduced to device intervals, kernel time by name and kind, the device's
busy time as the union of its intervals, and the breakdown the result
line carries.

Nothing is written to disk: the events are read from the profiler's
results in memory.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

WINDOW = "port_bench.window"

# kernel kinds by substrings of the kernel's name, first match wins
# (the grouping of the repository's profile_port.py)
KINDS = (
    ("nms_kernel", ("nms_kernel",)),
    ("int8_conv_kernel", ("qconv_kernel", "qconv_mma_kernel",
                          "qconv_dp4a_kernel")),
    ("requant_kernel", ("requant_kernel",)),
    ("window_kernel", ("window_rows_kernel", "window_elem_kernel",
                       "window_kernel")),
    ("rasterizer_kernel", ("boxes_kernel", "landmarks_kernel",
                           "maps_kernel")),
    ("ohem_kernel", ("ohem_kernel",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("sort", ("sort", "radix")),
    ("max_pool", ("max_pool",)),
    ("relu", ("clamp",)),
    ("add", ("functor_add",)),
    ("conv_backward", ("dgrad", "wgrad", "bprop", "backward_data",
                       "backward_filter", "bwd")),
    ("conv", ("conv", "cudnn", "implicit", "xmma_fprop")),
    ("gemm", ("gemm", "cutlass", "matmul", "nvjet")),
    ("copy", ("memcpy", "memset")),
    ("elementwise", ("vectorized_elementwise_kernel",
                     "native::elementwise_kernel",
                     "unrolled_elementwise_kernel")),
)


def kernel_kind(name: str) -> str:
    n = name.lower()
    for kind, keys in KINDS:
        if any(k in n for k in keys):
            return kind
    return "other"


class Summary:
    """Device intervals (ns, name) and host ops inside the window."""

    def __init__(self, device: List[Tuple[int, int, str]],
                 host: List[Tuple[int, int, str]], window: Tuple[int, int]):
        self.window = window
        lo, hi = window
        self.device = [(max(s, lo), min(e, hi), n) for s, e, n in device
                       if e > lo and s < hi]
        self.host = host

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """The union of the device's intervals, in seconds."""
        total, end = 0, None
        for s, e, _ in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def kernel_s(self, match) -> float:
        """Summed device time of the intervals whose name ``match``
        accepts (overlaps counted in full)."""
        return sum(e - s for s, e, n in self.device if match(n)) / 1e9

    def alone_s(self, match) -> float:
        """Seconds in which an interval that ``match`` accepts runs on the
        device and no other interval does."""
        edges = []
        for s, e, n in self.device:
            m = bool(match(n))
            edges += [(s, 1, m), (e, -1, m)]
        edges.sort(key=lambda x: (x[0], x[1]))
        total, mine, others, last = 0, 0, 0, None
        for t, d, m in edges:
            if mine and not others:
                total += t - last
            last = t
            if m:
                mine += d
            else:
                others += d
        return total / 1e9

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, n in self.device:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        out, end = [], self.window[0]
        for s, e, _ in sorted(self.device):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return out

    def _longest_gaps(self, top: int) -> List[Tuple[int, int]]:
        return sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]

    def for_breakdown(self, top: int = 10) -> "Summary":
        """This summary with only the host operations that name its ``top``
        longest idle gaps: the same breakdown, far fewer events to send."""
        mids = np.array([(s + e) // 2 for s, e in self._longest_gaps(top)],
                        dtype=np.int64)
        hs = np.array([h[0] for h in self.host], dtype=np.int64)
        he = np.array([h[1] for h in self.host], dtype=np.int64)
        keep = ((hs[:, None] <= mids) & (he[:, None] >= mids)).any(axis=1) \
            if mids.size and hs.size else np.zeros(hs.size, dtype=bool)
        host = [self.host[i] for i in np.flatnonzero(keep)]
        return Summary(self.device, host, self.window)

    def breakdown(self, top: int = 10) -> dict:
        """The ``top`` device operations by summed time, and the ``top``
        longest idle gaps, each named by the innermost host operation
        running at its middle."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = self._longest_gaps(top)
        hs = np.array([h[0] for h in self.host], dtype=np.int64)
        he = np.array([h[1] for h in self.host], dtype=np.int64)
        named = []
        for s, e in gaps:
            mid = (s + e) // 2
            inner = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (self.host[inner[np.argmin(he[inner] - hs[inner])]][2]
                    if inner.size else "host: no traced op")
            named.append([name, (e - s) / 1e9])
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": named}


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event."""
    import torch

    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        yield e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns()


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the block (CPU and CUDA activity) when ``enabled``; the
    block runs inside a ``WINDOW`` annotation. Afterwards ``out["summary"]``
    holds its ``Summary`` (None when not enabled)."""
    if not enabled:
        out["summary"] = None
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize()
        t = time.perf_counter()
    stop_s = time.perf_counter() - t
    device, host, window = [], [], None
    for name, dev, s, e in _events(prof):
        if dev:
            if name != WINDOW:      # not the annotation's device-side twin
                device.append((s, e, name))
        elif name == WINDOW:
            window = (s, e)
        else:
            host.append((s, e, name))
    if window is None:
        raise RuntimeError("the profiler's trace holds no window annotation")
    out["summary"] = Summary(device, host, window)
    print(f"port_bench.trace: {len(device)} device and {len(host)} host "
          f"events, profiler stop {stop_s:.1f} s, reading "
          f"{time.perf_counter() - t - stop_s:.1f} s", file=sys.stderr)
