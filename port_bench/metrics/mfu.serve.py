"""The device calls' share of the card's peak: the least time of one
image's convolutions and products at the peak of the dtype each runs in
(``port_bench/roofline``), times the requests the server answered in the
window (the slots a call pads with are no work a user asked for), over the
calls' summed spans, in %."""


def read(ctx):
    spans = ctx["spans"]
    if not spans:
        return None
    busy = sum(t1 - t0 for t0, t1 in spans)
    return 100.0 * ctx["least_s_per_image"] * ctx["stats"]["requests"] / busy
