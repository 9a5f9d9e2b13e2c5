"""The expert products' share of their roofline: the bounds of the
traced invocations' expert products (``work.moe_calls``: gate, up and
down at top-k, the weights of the experts expected to hold a token) over
the device time of the program's MoE product kernels, whose names hold
``moe_gmm``: the grouped GEMM of a prefill's sorted rows, and the
per-expert product and its slice sum of a decode step's few tokens. One
call a layer for the prefill over its B x S padded tokens, and one a
layer for each decode step the engine runs over its B rows (every step
launches the kernels, the last one's token unread included)."""

from portbench import readers, work

NAMES = ("moe_gmm",)


def calls(ctx, r):
    prefill = work.moe_calls(ctx.dims, r.batch * r.padded_len)
    step = work.moe_calls(ctx.dims, r.batch)
    for c in [prefill] + [step] * r.max_new:
        for _ in range(ctx.dims.layers):
            yield c


def read(ctx):
    return readers.roofline(ctx, NAMES, lambda r: calls(ctx, r))
