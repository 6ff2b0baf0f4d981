"""Device time of the convolutions and matrix products, forward and
backward (cuDNN and cuBLAS kernels: profile_port.py's kinds ``conv``,
``conv_backward`` and ``gemm``), per train step in the traced window, ms;
data-parallel: on the card busy longest."""

from port_bench.trace import kernel_kind


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["steps"]:
        return None
    s = tr.kernel_s(lambda n: kernel_kind(n) in ("conv", "conv_backward",
                                                 "gemm"))
    return s * 1e3 / ctx["steps"] if s > 0 else None
