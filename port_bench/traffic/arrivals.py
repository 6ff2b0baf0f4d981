"""An open loop's schedule: Poisson arrivals at a fixed rate.

Every seed gets the same set of gaps between arrivals and the same count,
in another order: the gaps are the exponential distribution's quantiles
at (k + 1/2) / n, shuffled by the seed. So runs on different seeds offer
the same work, and differ only in when its bursts come.
"""

from __future__ import annotations

import numpy as np


def poisson_due(rate_per_s: float, seconds: float,
                rng: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start, ascending, the first at
    0) of ``round(rate * seconds)`` requests."""
    n = max(1, int(round(rate_per_s * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_per_s
    gaps *= seconds / gaps.sum()
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def scene_order(n: int, pool: int, rng: np.random.Generator) -> np.ndarray:
    """Which pool scene each of ``n`` requests sends: the pool over and
    over, each pass in a shuffled order, so every scene is sent as often
    as any other, give or take one."""
    reps = -(-n // pool)
    return np.concatenate([rng.permutation(pool) for _ in range(reps)])[:n]
