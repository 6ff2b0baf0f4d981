"""Mean time a request waited in ``DetectServer``'s queue, from its
enqueue in ``submit`` to the worker taking it into a batch, over the
window: ``stats["queue_wait_s"]`` over ``stats["requests"]``, ms."""


def read(ctx):
    st = ctx["stats"]
    if "queue_wait_s" not in st or not st.get("requests"):
        return None
    return st["queue_wait_s"] / st["requests"] * 1e3
