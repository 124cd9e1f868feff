"""``flash_wgmma_kernel``'s share of its bound in the profiled stretch:
for each prefill, each layer's least time (the larger of 4 Dh flops an
admitted pair at 989 TFLOP/s and the least bytes at 3.35 TB/s; counts.py),
summed, over the kernel's summed device time, %.  Nothing when the
profile does not hold one launch a layer a prefill."""

from portbench import counts, profile


def read(ctx):
    st = ctx.stretch
    if st is None or not ctx.stretch_prefills:
        return None
    secs, launches = profile.kernel_time(st, "flash_wgmma_kernel")
    n_layers = ctx.arch["n_layers"]
    if launches != n_layers * len(ctx.stretch_prefills) or not secs:
        return None
    t = ctx.geom["cache_len"]
    bound = sum(counts.bound_s(counts.flash_flops(ctx.arch, n),
                               counts.flash_bytes(ctx.arch, n, b, t))
                for n, b in ctx.stretch_prefills)
    return 100.0 * bound * n_layers / secs
