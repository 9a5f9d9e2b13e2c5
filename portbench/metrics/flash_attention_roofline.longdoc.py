"""The prefill attention kernel's share of its roofline: the bounds of the
traced invocations' prefill calls (one a layer, live pairs, q, k, v in
and o out once), over the kernel's device time."""

from portbench import readers, work

NAMES = ("flash_attention",)


def calls(ctx, r):
    c = work.flash_call(ctx.dims, r.batch, r.padded_len)
    for _ in range(ctx.dims.layers):
        yield c


def read(ctx):
    return readers.roofline(ctx, NAMES, lambda r: calls(ctx, r))
