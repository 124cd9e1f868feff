"""Mean of the program's ``serving.prefill`` spans begun in the window
(an eager prefill up to its first token on the host), ms."""

from portbench import readers


def read(ctx):
    vals = readers.spans(ctx, "serving.prefill")
    return 1e3 * sum(vals) / len(vals) if vals else None
