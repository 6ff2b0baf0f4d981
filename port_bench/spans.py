"""Device time of the work the program issued inside its own spans.

The program records spans on the host clock (``densebox_tpu_torch/utils/
logging.py``'s ring, ``time.time_ns()``, which is the profiler's host
clock): a span marks when the host issued a block's work, not when the card
ran it, and in an offline run the host is calls ahead of the card. The
offline driver issues all its work from one thread on one stream, so the
card runs it in the order it was issued. The rule that ties a span to the
card's time:

1. The launches are the host's runtime and driver calls that put work on
   the card (names starting with one of ``LAUNCH``: kernel launches, copies,
   memsets) that start inside the traced window, in order of their start.
2. The card's operations are the trace's device intervals (``Summary.device``)
   in order of their start.
3. Where the two counts agree, the i-th launch ran as the i-th operation;
   a launch belongs to a span when it starts inside the span. Where they
   differ, a launch cannot be tied to its kernel and nothing is read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

LAUNCH = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
          "cuMemset")


def span_device_s(tr, name: str) -> Optional[float]:
    """Summed device seconds of the operations launched inside the ring's
    ``name`` spans of the traced window; None without a trace, without the
    ring or such a span, when the ring lost spans of the window, or when
    launches and operations do not pair up (the rule above)."""
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
    spans = sorted((s, e) for n, s, e, _, _ in spans_between(lo, hi)
                   if n == name)
    if not spans:
        return None
    launches = np.sort(np.array([s for s, _, n in tr.host
                                 if lo <= s <= hi and n.startswith(LAUNCH)],
                                dtype=np.int64))
    ops = sorted(tr.device)
    if launches.size != len(ops):
        return None
    dur = np.array([e - s for s, e, _ in ops], dtype=np.int64)
    total = 0
    for s, e in spans:
        i = int(np.searchsorted(launches, s, side="left"))
        j = int(np.searchsorted(launches, e, side="right"))
        total += int(dur[i:j].sum())
    return total / 1e9
