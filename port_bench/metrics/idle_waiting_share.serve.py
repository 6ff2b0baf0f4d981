"""The share of the card's idle time in the traced window that lies under
a ``serve.idle`` or ``serve.window`` span of ``DetectServer``'s worker: the
card idle because the server waited for requests or held its batch window
open, in % of the union of ``Summary.gaps()``. The spans come from the
program's ring (``densebox_tpu_torch/utils/logging.py``, on the
profiler's clock); None without a trace, without the ring, or when the
ring lost spans of the window."""

WORKER = ("serve.idle", "serve.window", "serve.fill", "serve.detect",
          "serve.fetch", "serve.scatter")
WAITING = ("serve.idle", "serve.window")


def _union(spans):
    """Sorted disjoint intervals covering spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a, b):
    """The length of the intersection of two sorted disjoint lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    try:
        from densebox_tpu_torch.utils.logging import (spans_between,
                                                      spans_dropped)
    except ImportError:         # a program without the span ring
        return None
    lo, hi = tr.window
    if spans_dropped(lo):
        return None
    spans = [(n, s, e) for n, s, e, _, _ in spans_between(lo, hi)]
    worker = [(s, e) for n, s, e in spans if n in WORKER]
    waiting = [(s, e) for n, s, e in spans if n in WAITING]
    gaps = tr.gaps()
    idle = sum(e - s for s, e in gaps)
    if not worker or idle <= 0:
        return None
    return 100.0 * _overlap_ns(gaps, _union(waiting)) / idle
