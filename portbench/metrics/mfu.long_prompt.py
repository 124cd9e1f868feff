"""Useful model flops of the window (prompt tokens without pads, every
decoded token, only the experts a token is routed to, attention over the
admitted positions; counts.py) over the window's seconds at the H100's
989 TFLOP/s bf16 peak, %."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
