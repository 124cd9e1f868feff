"""The program's ``serving.prefill`` spans begun in the window, summed,
over the window's seconds, %."""

from portbench import readers


def read(ctx):
    vals = readers.spans(ctx, "serving.prefill")
    return 100.0 * sum(vals) / ctx.seconds if vals else None
