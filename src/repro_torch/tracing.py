"""The port's spans and counters: one store for the whole process.

Spans time the host side of the serving loop. ``with span(name, **attrs):``
records the name, the start and end on ``time.perf_counter()``, the
enclosing span (``parent``, its ``id``) and the invocation it belongs to:
a span given ``invocation=`` opens one, the spans inside it inherit it.
``perf_counter`` is the clock onto which the benchmark maps the device's
trace (``portbench/devtrace.py``), so spans lie over the device timeline
as they are. Spans are off until :func:`enable`; while off, :func:`span`
returns one shared object that records nothing and reads no clock.
:func:`drain` returns what was recorded and forgets it.

Counters are always on: :func:`count` adds to a dict, an integer add
beside the work it counts (a kernel launch, a flushed row, a read of the
device's memory). A fact a span records (a decode step, a flush) is read
from the spans, not counted twice.

The serving loop runs on one thread; so does this store.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple


class Span:
    """One timed region; also the context manager that records it."""

    __slots__ = ("id", "name", "start", "end", "parent", "invocation", "attrs")

    def __init__(self, id: int, name: str, parent: Optional["Span"],
                 invocation: Optional[int], attrs: Dict):
        self.id, self.name, self.attrs = id, name, attrs
        self.parent = parent.id if parent is not None else None
        if invocation is None and parent is not None:
            invocation = parent.invocation
        self.invocation = invocation
        self.start = self.end = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def set(self, **attrs) -> None:
        """Attributes known only once the region has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        _stack.append(self)
        _spans.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        _stack.pop()
        return False


class _Off:
    """What :func:`span` returns while spans are off."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()
_on = False
_next_id = 0
_spans: List[Span] = []
_stack: List[Span] = []
_counters: Dict[str, int] = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, invocation: Optional[int] = None, **attrs):
    """A region to time (a context manager); ``OFF`` while spans are off."""
    global _next_id
    if not _on:
        return OFF
    _next_id += 1
    return Span(_next_id, name, _stack[-1] if _stack else None, invocation, attrs)


def drain() -> List[Span]:
    """The spans recorded since the last drain, in the order they started."""
    global _spans
    out, _spans = _spans, []
    return out


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    return dict(_counters)


def reset_counters(prefix: str = "") -> None:
    """Forget the counters whose names start with ``prefix`` (all by default)."""
    for k in [k for k in _counters if k.startswith(prefix)]:
        del _counters[k]


def self_intervals(spans: Sequence[Span]) -> Dict[int, List[Tuple[float, float]]]:
    """Each span's own time, by id: its interval less its children's."""
    kids: Dict[int, List[Span]] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    out = {}
    for s in spans:
        parts, t = [], s.start
        for c in sorted(kids.get(s.id, ()), key=lambda c: c.start):
            if c.start > t:
                parts.append((t, c.start))
            t = max(t, c.end)
        if s.end > t:
            parts.append((t, s.end))
        out[s.id] = parts
    return out


def write_chrome_trace(path: str, spans: Sequence[Span], counts: Dict[str, int]) -> None:
    """Spans as complete events and counters as one counter event each,
    in the Chrome trace format (microseconds), for Perfetto."""
    pid = os.getpid()
    events = []
    for s in spans:
        args = dict(s.attrs, id=s.id, parent=s.parent, invocation=s.invocation)
        events.append({"name": s.name, "ph": "X", "ts": s.start * 1e6,
                       "dur": s.seconds * 1e6, "pid": pid, "tid": 0, "args": args})
    end = max((s.end for s in spans), default=time.perf_counter()) * 1e6
    for name, v in sorted(counts.items()):
        events.append({"name": name, "ph": "C", "ts": end, "pid": pid, "args": {"value": v}})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
