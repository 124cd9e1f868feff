"""Tokens generated in the window over the window's seconds (host clock,
the engine's token timestamps): every token of every request counts."""

from portbench import readers


def read(ctx):
    n = sum(1 for r in ctx.requests for t in r.t_tokens
            if readers.in_window(ctx, t))
    return n / ctx.seconds if n else None
