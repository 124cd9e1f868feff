"""``decode_kernel``'s share of its bound in the profiled stretch: for
each decode step, each layer's least time (the larger of 4 Dh flops an
admitted pair at 989 TFLOP/s and the least bytes at 3.35 TB/s: q, the
output, the positions, the admitted K and V rows; counts.py), summed,
over the kernel's summed device time, %.  Nothing when the profile does
not hold one launch a layer a step."""

from portbench import counts, profile


def read(ctx):
    st = ctx.stretch
    if st is None or not ctx.stretch_rows:
        return None
    secs, launches = profile.kernel_time(st, "decode_kernel")
    if launches != ctx.arch["n_layers"] * len(ctx.stretch_rows) or not secs:
        return None
    slots, t = ctx.geom["num_slots"], ctx.geom["cache_len"]
    bound = sum(counts.bound_s(counts.attention_flops(ctx.arch, rows),
                               counts.decode_bytes(ctx.arch, slots, rows, t))
                for rows in ctx.stretch_rows)
    return 100.0 * bound * ctx.arch["n_layers"] / secs
