"""95th percentile, over every request that finished in the window, of
its time per output token after the first: (t_done - t_first_token) /
(tokens - 1), in ms."""

from portbench import readers


def read(ctx):
    vals = [(r.t_done - r.t_first_token) / (len(r.generated) - 1) * 1e3
            for r in ctx.requests
            if readers.in_window(ctx, r.t_done) and len(r.generated) > 1]
    return readers.percentile(vals, 95)
