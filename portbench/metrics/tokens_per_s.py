"""Prompt tokens (unpadded) and generated tokens of the completed
invocations over the time from the window's start to the last token."""

from portbench import readers


def read(ctx):
    return readers.tokens_per_s(ctx)
