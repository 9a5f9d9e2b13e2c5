"""Useful model operations of every forward pass of the traced invocations
of a hybrid of Mamba2 and attention layers with experts
(``work_hybrid.invocation_flops``: each layer counted as its kind, the
Mamba2 projections, conv and SSD, or the attention projections and live
pairs; the router, top-k experts and shared expert in every layer; the
head only where its logits are read) over the traced window at the card's
bf16 peak, in percent. None where the configuration has no such layers."""

from portbench import readers, work, work_hybrid


def read(ctx):
    if ctx.trace is None or not ctx.traced or "layer_types" not in ctx.spec.config:
        return None
    hm = work_hybrid.dims(ctx.spec.config)
    ops = sum(work_hybrid.invocation_flops(hm, r.batch, r.padded_len, r.max_new,
                                           ctx.cache_window) for r in ctx.traced)
    return readers.share(ops / work.PEAK_FLOPS, ctx.trace.window_s)
