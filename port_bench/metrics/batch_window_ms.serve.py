"""Mean time ``DetectServer`` held a batch open, from the first request
taken to the batch closed (full or at the window's end), over the window:
``stats["window_s"]`` over ``stats["device_calls"]``, ms."""


def read(ctx):
    st = ctx["stats"]
    if "window_s" not in st or not st.get("device_calls"):
        return None
    return st["window_s"] / st["device_calls"] * 1e3
