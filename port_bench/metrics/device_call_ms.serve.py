"""Mean wall time of the server's device calls in the window: a span
around its detect function, from the call to the card's finish (the
server then copies the results back), ms."""


def read(ctx):
    spans = ctx["spans"]
    if not spans:
        return None
    return sum(t1 - t0 for t0, t1 in spans) / len(spans) * 1e3
