"""95th percentile of the queue wait (t_admitted - scheduled arrival)
over every request that arrived in the window, in ms; one not admitted
when the wait ends counts with the time waited so far."""

from portbench import readers


def read(ctx):
    vals = [readers.waited(ctx, r.t_admitted, r.arrival_time) * 1e3
            for r in readers.arrived(ctx)]
    return readers.percentile(vals, 95)
