"""Device time of the landmark decode per image detected in the traced
window, ms: the operations launched under the program's
``detect.landmarks`` spans (the scale pick, the window gather, the peak
search and the sub-pixel fit of ``infer/detector.py``), tied to their
spans by ``port_bench/spans.py``'s rule. None without a trace or without
the spans."""

from port_bench.spans import span_device_s


def read(ctx):
    s = span_device_s(ctx["trace"], "detect.landmarks")
    if s is None or not ctx["images"]:
        return None
    return s * 1e3 / ctx["images"]
