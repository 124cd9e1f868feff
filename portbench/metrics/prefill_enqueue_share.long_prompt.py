"""The program's ``engine.prefill.enqueue`` spans (the cache reset,
``forward``, the scatter and ``sample``, up to the first token's sync)
over its ``serving.prefill`` spans, both begun in the window, summed, %:
near 100 the host sets the prefill's pace; a synchronising call inside
``forward`` counts as enqueue."""

from portbench import device_spans


def read(ctx):
    return device_spans.enqueue_share(ctx)
