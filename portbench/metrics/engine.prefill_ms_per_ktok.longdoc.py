"""The engine's prefill time (its own synchronised host timing) per
thousand padded prompt tokens over the traced invocations, in ms."""


def read(ctx):
    tokens = sum(r.batch * r.padded_len for r in ctx.traced if not r.failed)
    return sum(r.prefill_s for r in ctx.traced) / tokens * 1e6 if tokens else None
