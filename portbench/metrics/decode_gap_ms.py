"""Mean device-idle time between consecutive ``device.decode_step`` spans
begun in the window with no ``device.prefill`` between them (next start
less previous end, on the engine's clock): the host's work from one
step's tokens to the next step's launch, ms."""

from portbench import device_spans


def read(ctx):
    gaps = device_spans.decode_gaps(ctx)
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
