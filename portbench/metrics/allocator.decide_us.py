"""Host time of Shabari's decision per invocation: featurize and allocate
before the engine runs, and feedback after it, in microseconds, over the
traced invocations (spans taken by the harness around the calls)."""


def read(ctx):
    if not ctx.traced:
        return None
    spent = sum((r.t_alloc - r.start) + (r.end - r.t_gen) for r in ctx.traced)
    return spent / len(ctx.traced) * 1e6
