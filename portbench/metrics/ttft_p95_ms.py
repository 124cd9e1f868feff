"""95th percentile of the time to first token, from each request's
scheduled arrival, over every request that arrived in the window, in ms;
one still without its first token when the wait ends counts with the
time it has waited so far."""

from portbench import readers


def read(ctx):
    vals = [readers.waited(ctx, r.t_first_token, r.arrival_time) * 1e3
            for r in readers.arrived(ctx)]
    return readers.percentile(vals, 95)
