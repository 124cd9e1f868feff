"""Process start to the window's open (host clock): imports, the kernels'
build on a first run, the weights, the engine and its capture, every
bucket's warm-up and the traffic's own warm-up."""


def read(ctx):
    return ctx.setup_s
