"""Caches of constant tensors that tracing cannot poison.

The detect path keeps small constant tensors (resize and upsample weights,
per-scale tables, the int8 epilogue vectors) made once per process, since an
upload from pageable memory on every call would stall the host until the
card drains its queue. While ``torch.export`` (or ``torch.compile``) traces
the path, the same functions run on fake tensors; were those kept, every
later live call in the process would read them. So a cache keeps a value
only when it is a plain tensor, and a traced program reads what an earlier
live call kept (a constant of the program) or builds its own.
"""

from __future__ import annotations

import functools

import torch


def is_plain(t) -> bool:
    """True for a real tensor, False for the fake or functional tensors of
    a trace."""
    return type(t) is torch.Tensor


def constant_cache(build):
    """Memoise ``build(*args)`` (hashable arguments, a tensor result) like
    ``functools.lru_cache(maxsize=None)``, keeping only plain tensors.
    ``cache_clear()`` empties it."""
    cache: dict = {}

    @functools.wraps(build)
    def get(*args):
        t = cache.get(args)
        if t is None:
            t = build(*args)
            if is_plain(t):
                cache[args] = t
        return t

    get.cache_clear = cache.clear
    return get
