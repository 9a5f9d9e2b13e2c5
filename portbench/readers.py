"""Arithmetic the metric readers share (``metrics/<name>.py``). Each reader
takes the run's :class:`portbench.harness.Context` and returns a number,
or None where its run has nothing to read."""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence

from portbench import work


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest rank: the smallest value with at least ``q`` percent of
    the values at or below it."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def latencies_ms(ctx) -> list:
    """Due time to last token of every attempted invocation; a failed one
    never finished (infinite)."""
    return [math.inf if r.failed else (r.t_gen - r.due) * 1e3 for r in ctx.records]


def tokens_per_s(ctx) -> Optional[float]:
    """Prompt tokens (unpadded) and generated tokens of the completed
    invocations over the time from the window's start to the last token."""
    done = [r for r in ctx.records if not r.failed]
    if not done:
        return None
    tokens = sum(r.prompt_tokens + r.batch * r.max_new for r in done)
    return tokens / (max(r.t_gen for r in done) - ctx.t0)


def share(part: float, whole: float) -> Optional[float]:
    return 100.0 * part / whole if whole > 0 else None


def mfu(ctx) -> Optional[float]:
    """Useful model operations of the traced invocations over the traced
    window at the peak."""
    if ctx.trace is None or not ctx.traced:
        return None
    ops = sum(work.invocation_flops(ctx.dims, r.batch, r.padded_len, r.max_new, ctx.cache_window)
              for r in ctx.traced)
    return share(ops / work.PEAK_FLOPS, ctx.trace.window_s)


def roofline(ctx, names: Sequence[str], calls: Callable[[object], Iterable[dict]]
             ) -> Optional[float]:
    """Sum of the bounds of the traced invocations' calls (``calls(record)``
    yields each call's ops and bytes) over the device time of the kernels
    whose names hold one of ``names``."""
    if ctx.trace is None or not ctx.traced:
        return None
    t = ctx.trace.seconds_by_name(names)
    bound = sum(work.bound_s(c["ops"], c["bytes"]) for r in ctx.traced for c in calls(r))
    return share(bound, t) if t > 0 and bound > 0 else None


def idle_share(ctx) -> Optional[float]:
    """Share of the traced invocations' service time with no device work."""
    if ctx.trace is None or not ctx.traced:
        return None
    spans = [(r.start, r.end) for r in ctx.traced]
    total = sum(b - a for a, b in spans)
    return share(total - ctx.trace.busy(spans), total)
