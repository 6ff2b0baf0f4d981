"""The share of the traced window in which no operation ran on the card:
1 - (union of the device's intervals) / window, in %; with more than one
card, on the card where it is largest."""


def read(ctx):
    traces = [t for t in ctx.get("traces") or [ctx["trace"]]
              if t is not None and t.device]
    if not traces:
        return None
    return max(100.0 * (1.0 - t.busy_s() / t.window_s) for t in traces)
