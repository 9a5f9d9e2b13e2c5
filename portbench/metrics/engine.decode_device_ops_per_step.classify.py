"""Device operations (kernels, copies, sets) a decode step over the traced
invocations: those whose device start lies in an invocation's decode phase
(the engine's ``decode_s`` anchored at its last token, as
``devtrace.spans_by_phase`` has it), over its decode steps. The phase opens
after the prefill's synchronise and closes with the last step's, so every
operation a step launches starts inside it."""

import bisect

from portbench import devtrace


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    steps = sum(r.max_new for r in ctx.traced if not r.failed)
    if not steps:
        return None
    starts = [k[1] for k in ctx.trace.kernels]
    ops = sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
              for a, b in devtrace.spans_by_phase(ctx.traced)["engine.decode"])
    return ops / steps
