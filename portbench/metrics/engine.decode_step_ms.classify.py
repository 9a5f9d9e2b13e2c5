"""The engine's decode time (its own synchronised host timing) per decode
step over the traced invocations, in ms. The engine runs one step for each
served token of a row, the batch's rows together."""


def read(ctx):
    steps = sum(r.max_new for r in ctx.traced if not r.failed)
    return sum(r.decode_s for r in ctx.traced) / steps * 1e3 if steps else None
