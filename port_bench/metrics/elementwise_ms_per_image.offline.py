"""Device time of torch's elementwise kernels (profile_port.py's kind
``elementwise``) per image detected in the traced window, ms."""

from port_bench.trace import kernel_kind


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["images"]:
        return None
    s = tr.kernel_s(lambda n: kernel_kind(n) == "elementwise")
    return s * 1e3 / ctx["images"] if s > 0 else None
