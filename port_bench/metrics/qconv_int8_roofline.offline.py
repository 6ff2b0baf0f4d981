"""qconv_int8's share of its roofline: the summed least time of the
window's launches (each launch's shape: the larger of its operations over
1,979 TOP/s and its bytes over 3.35 TB/s, ``port_bench/roofline``) over
their summed device time in the trace, in %."""


def read(ctx):
    tr = ctx["trace"]
    bound = ctx.get("qconv_bound_s_per_call")
    if tr is None or bound is None:
        return None
    s = tr.kernel_s(lambda n: "qconv_mma_kernel" in n
                    or "qconv_dp4a_kernel" in n)
    return 100.0 * bound * ctx["calls"] / s if s > 0 else None
