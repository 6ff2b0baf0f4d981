"""Host work of ``DetectServer``'s worker around a device call, over the
window: filling the pinned buffer and issuing its copy (``fill_s``) plus
slicing and handing out the results (``scatter_s``), per device call, ms."""


def read(ctx):
    st = ctx["stats"]
    if "fill_s" not in st or not st.get("device_calls"):
        return None
    return (st["fill_s"] + st["scatter_s"]) / st["device_calls"] * 1e3
