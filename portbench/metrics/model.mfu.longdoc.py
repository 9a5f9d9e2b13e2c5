"""Useful model operations of every forward pass of the traced invocations
(``work.invocation_flops``: pads attended, attention over live pairs, the
head only where its logits are used, experts at top-k) over the traced
window at the card's bf16 peak, in percent."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx)
