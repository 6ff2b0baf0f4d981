"""Device time of the refine branch per image detected in the traced
window, ms: the operations launched under the program's ``model.refine``
spans (the score ++ landmark concat, its quantise and the branch's three
convs, at every pyramid scale), tied to their spans by
``port_bench/spans.py``'s rule. None without a trace or without the
spans."""

from port_bench.spans import span_device_s


def read(ctx):
    s = span_device_s(ctx["trace"], "model.refine")
    if s is None or not ctx["images"]:
        return None
    return s * 1e3 / ctx["images"]
