"""Process start to the first due invocation: imports, the kernels' build
or load, the weights from the seed, the warm-up of this cell's shapes."""


def read(ctx):
    return ctx.setup_s
