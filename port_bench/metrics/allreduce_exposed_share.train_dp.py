"""The share of the traced window in which an NCCL kernel runs on the card
and no other kernel does (communication that nothing hides), in %, on the
rank where it is largest."""


def _nccl(name):
    return "nccl" in name.lower()


def read(ctx):
    traces = ctx.get("traces")
    if not traces or not any(t.kernel_s(_nccl) > 0 for t in traces):
        return None
    return max(100.0 * t.alone_s(_nccl) / t.window_s for t in traces)
