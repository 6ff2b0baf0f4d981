"""How late the load generator sent: the 95th percentile over the
window's requests of (send time - due time), ms."""

import numpy as np


def read(ctx):
    lags = np.asarray(ctx["lags_s"], dtype=np.float64)
    lags = lags[np.isfinite(lags)]
    if not lags.size:
        return None
    v = np.sort(lags)
    return float(v[max(0, int(np.ceil(0.95 * len(v))) - 1)]) * 1e3
