"""The device trace of a run: ``torch.profiler`` over CUDA activity only,
read from the profiler's raw events (no per-event Python objects beyond
a name and two times), with device times mapped onto the host's
``time.perf_counter`` by a marker kernel launched right after a
synchronise."""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Dict, List, Sequence, Tuple

import torch

Interval = Tuple[float, float]


@dataclasses.dataclass
class DeviceTrace:
    kernels: List[Tuple[str, float, float]]  # (name, start, end), host seconds, by start
    window: Interval  # the traced window, host seconds

    def __post_init__(self):
        merged: List[List[float]] = []
        for _, s, e in self.kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self._busy = [(a, b) for a, b in merged]
        self._starts = [a for a, _ in self._busy]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, spans: Sequence[Interval]) -> float:
        """Seconds within ``spans`` (disjoint) in which the device ran anything."""
        tot = 0.0
        for a, b in spans:
            i = max(0, bisect.bisect_right(self._starts, a) - 1)
            while i < len(self._busy) and self._busy[i][0] < b:
                s, e = self._busy[i]
                tot += max(0.0, min(e, b) - max(s, a))
                i += 1
        return tot

    def seconds_by_name(self, names: Sequence[str]) -> float:
        a, b = self.window
        return sum(min(e, b) - max(s, a) for n, s, e in self.kernels
                   if s < b and e > a and any(k in n for k in names))

    def top_ops(self, n: int = 10) -> List[List]:
        """The ``n`` operations that took the most device time, by short name."""
        tot: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = short_name(name)
            tot[key] = tot.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and its argument list, cut to ``width``."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


class Tracer:
    """Start and stop the profiler around part of the window."""

    def __init__(self):
        self.prof = None
        self.t_mark = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        torch.empty(1, device="cuda").fill_(0.0)  # the marker: the trace's first kernel
        torch.cuda.synchronize()

    def stop(self, window: Interval) -> DeviceTrace:
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.prof.stop()
        raw = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            if hasattr(ev, "start_ns"):
                s, d = ev.start_ns(), ev.duration_ns()
            else:
                s, d = ev.start_us() * 1000, ev.duration_us() * 1000
            raw.append((s, d, ev.name()))
        self.prof = None
        if not raw:
            raise RuntimeError("the profiler's trace holds no device activity")
        raw.sort()
        base = raw[0][0]
        kernels = [(n, self.t_mark + (s - base) / 1e9, self.t_mark + (s + d - base) / 1e9)
                   for s, d, n in raw[1:]]
        return DeviceTrace(kernels, window)


def spans_by_phase(records) -> Dict[str, List[Interval]]:
    """Host phases of the traced invocations: the allocator (featurize,
    allocate; feedback), the engine's prefill and decode (from its own
    timings, anchored at the call's ends) and the rest of the call."""
    out: Dict[str, List[Interval]] = {"allocator": [], "engine.prefill": [],
                                      "engine.decode": [], "engine.other": []}
    for r in records:
        out["allocator"] += [(r.start, r.t_alloc), (r.t_gen, r.end)]
        pre_end = min(r.t_alloc + r.prefill_s, r.t_gen)
        dec_start = max(r.t_gen - r.decode_s, pre_end)
        out["engine.prefill"].append((r.t_alloc, pre_end))
        out["engine.decode"].append((dec_start, r.t_gen))
        out["engine.other"].append((pre_end, dec_start))
    return out


def idle_by_phase(trace: DeviceTrace, records) -> List[List]:
    """Idle device seconds by what the host was doing, longest first; the
    time outside every invocation's service is "no invocation"."""
    out = []
    for phase, spans in spans_by_phase(records).items():
        out.append([phase, sum(b - a for a, b in spans) - trace.busy(spans)])
    a, b = trace.window
    service = [(r.start, r.end) for r in records]
    out.append(["no invocation", (b - a) - sum(e - s for s, e in service)
                - (trace.busy([(a, b)]) - trace.busy(service))])
    return sorted(out, key=lambda kv: -kv[1])[:10]

