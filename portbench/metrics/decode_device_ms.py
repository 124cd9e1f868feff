"""Mean of the program's ``device.decode_step`` spans begun in the window:
the captured step on the device, from the CUDA graph's first node to its
last (timing events captured in the graph; where CUDA cannot time those,
events around the copy-in and the replay, so the span holds the
copy-in and the launch's latency too), ms."""

from portbench import readers


def read(ctx):
    vals = readers.spans(ctx, "device.decode_step")
    return 1e3 * sum(vals) / len(vals) if vals else None
