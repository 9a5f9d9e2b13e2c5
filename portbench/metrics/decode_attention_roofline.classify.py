"""The decode attention kernel's share of its roofline: the bounds of the
traced invocations' useful decode calls (one a layer for each served token
after the first: q and the live K/V in, o out once), over the kernel's
device time."""

from portbench import readers, work

NAMES = ("decode_attention",)


def calls(ctx, r):
    for j in range(r.max_new - 1):
        c = work.decode_call(ctx.dims, r.batch, r.padded_len + j, ctx.cache_window)
        for _ in range(ctx.dims.layers):
            yield c


def read(ctx):
    return readers.roofline(ctx, NAMES, lambda r: calls(ctx, r))
