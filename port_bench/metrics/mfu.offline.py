"""The detect call's share of the card's peak: the least time of a call's
convolutions and products at the peak of the dtype each runs in
(``port_bench/roofline``), times the calls, over the window, in %."""


def read(ctx):
    if not ctx["calls"]:
        return None
    return 100.0 * ctx["least_s_per_call"] * ctx["calls"] / ctx["window_s"]
