"""Device time of the NCCL kernels (every kernel whose name holds
``nccl``: the gradients' flat all-reduce, the loss counts' and the
metrics' sums) per step of the window, in ms, on the rank where it is
largest. A collective's kernel runs from its launch on that card until
the last rank has joined, so the waiting for a slower rank is in it."""


def _nccl(name):
    return "nccl" in name.lower()


def read(ctx):
    traces = ctx.get("traces")
    if not traces or not ctx["steps"]:
        return None
    s = max(t.kernel_s(_nccl) for t in traces)
    return s * 1e3 / ctx["steps"] if s > 0 else None
