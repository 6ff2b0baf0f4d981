"""Requests per device call over the window, from ``DetectServer.stats``:
how far the server's window coalesced them."""


def read(ctx):
    calls = ctx["stats"].get("device_calls", 0)
    return ctx["stats"]["requests"] / calls if calls else None
