"""Mean of the program's ``serving.decode_step`` spans begun in the
window (the graph's replay up to its tokens on the host), ms."""

from portbench import readers


def read(ctx):
    vals = readers.spans(ctx, "serving.decode_step")
    return 1e3 * sum(vals) / len(vals) if vals else None
