"""The share of the traced window in which no operation ran on the card:
1 - (union of the device's intervals) / window, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
