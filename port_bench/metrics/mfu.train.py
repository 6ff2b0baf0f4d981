"""The train step's share of the card's peak: the least time of a step's
convolutions and products, forward and backward, at 67 TFLOP/s (float32
with TF32 off; ``port_bench/roofline``), times the steps, over the
window, in %. Data-parallel: a card's share, from one rank's rows of the
global batch; every rank does the same work, so it is also the share of
all the cards' peak."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return 100.0 * ctx["least_s_per_step"] * ctx["steps"] / ctx["window_s"]
