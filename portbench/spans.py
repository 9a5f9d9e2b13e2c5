"""The program's own spans and counters over runs of a cell, read against
the harness's records and the device trace, in one process.

    python3 portbench/spans.py --workload <cell> --seeds 11,12 [--seconds 20]
        [--spans 1,0,0,1]

The harness never turns the program's tracer on (``repro_torch.tracing``),
so its result line holds none of these readings. For each seed, and for
each value of ``--spans`` in turn, a run: the tracer on (1) or left off
(0) from before set-up, so kernel builds and the warm-up are recorded
too; then the harness's set-up and window with the device trace
(``harness.serve(..., trace=True)``); then one JSON line:

- ``per_layer``: the cell's per-layer metrics as its readers read them,
  so runs with the tracer on and off compare its cost;
- with the tracer on, ``spans``: over the traced invocations (a span
  belongs to the invocation whose service, featurize to feedback, holds
  it) the mean ``engine.decode.launch`` in ms, the share of decode steps
  whose token is read, the allocator's spans a call in us; ``on_device``:
  the device operations that start inside the decode steps' launch and
  wait spans a step (:func:`device_readings`); ``idle_by_span``: device idle seconds in each span's own time (the
  span less its children), by name, the rest of each service under
  ``invocation``, the window outside every service under ``no
  invocation``, with the sum over the services beside the idle share's
  numerator; ``setup``: seconds in each top-level span before the window;
  ``counters``: what the program's counters added over the run, set-up
  included.

No line decides ``correct``: the harness's own runs do.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DECODE = ("engine.decode.launch", "engine.decode.wait")
ALLOCATOR = ("allocator.featurize", "allocator.allocate", "allocator.feedback")


def by_invocation(spans, records) -> Dict[int, list]:
    """The spans inside each record's service (``start`` to ``end``), by
    the record's position; the invocations ran one at a time."""
    starts = [r.start for r in records]
    out: Dict[int, list] = {}
    for s in spans:
        i = bisect.bisect_right(starts, s.start) - 1
        if i >= 0 and s.end <= records[i].end:
            out.setdefault(i, []).append(s)
    return out


def readings(spans, records) -> Dict[str, Optional[float]]:
    """The host-side readings of the spans inside ``records``' services."""
    mine = [s for group in by_invocation(spans, records).values() for s in group]
    launch = [s for s in mine if s.name == "engine.decode.launch"]
    alloc = sum(s.seconds for s in mine if s.name in ALLOCATOR)
    return {
        "decode_launch_ms": (sum(s.seconds for s in launch) / len(launch) * 1e3
                             if launch else None),
        "decode_steps_read": (100.0 * sum(bool(s.attrs["read"]) for s in launch) / len(launch)
                              if launch else None),
        "decode_steps": len(launch),
        "allocator_span_us": alloc / len(records) * 1e6 if records else None,
    }


def device_readings(trace, spans, records, layers: int) -> Dict:
    """What the device ran inside the decode steps' launch and wait spans:
    its operations (kernels, copies, sets) a step, the most frequent by
    name a step, and the share of the ``layers`` decode attention launches
    a step that the trace holds. Then, for each prefill wait of 1 ms or
    more (the host blocked in a synchronise, so the device ran to the
    wait's end), the wait's end less the end of the last operation that
    started inside it, in ms: a few hundredths where the device's timeline
    lies on the host's."""
    from portbench.devtrace import short_name

    mine = [s for group in by_invocation(spans, records).values() for s in group]
    steps = sum(s.name == "engine.decode.launch" for s in mine)
    starts = [k[1] for k in trace.kernels]

    def inside(s):
        return trace.kernels[bisect.bisect_left(starts, s.start):
                             bisect.bisect_left(starts, s.end)]

    names: Dict[str, int] = {}
    for s in mine:
        if s.name in DECODE:
            for k in inside(s):
                key = short_name(k[0], 64)
                names[key] = names.get(key, 0) + 1
    gaps = sorted((s.end - max(k[2] for k in ks)) * 1e3 for s in mine
                  if s.name == "engine.prefill.wait" and s.seconds >= 1e-3
                  for ks in [inside(s)] if ks)
    out = {"steps": steps, "sync_gap_ms": {
        "waits": sum(s.name == "engine.prefill.wait" and s.seconds >= 1e-3 for s in mine),
        "with_ops": len(gaps), "min": gaps[0] if gaps else None,
        "median": gaps[len(gaps) // 2] if gaps else None, "max": gaps[-1] if gaps else None}}
    if steps:
        dec = sum(v for k, v in names.items() if "decode_attention" in k)
        out["ops_per_step"] = sum(names.values()) / steps
        out["decode_attention_kept_pct"] = 100.0 * dec / (steps * layers)
        out["ops_by_name_per_step"] = [[k, v / steps] for k, v in sorted(
            names.items(), key=lambda kv: -kv[1])[:12]]
    return out


def idle_by_span(trace, spans, records) -> Dict:
    """Device idle seconds in each span's own time, by name, longest first
    (top 10); each service's time outside every program span is
    ``invocation``; the window outside every service ``no invocation``."""
    from repro_torch import tracing

    groups = by_invocation(spans, records)
    idle: Dict[str, float] = {}

    def add(name, parts):
        idle[name] = idle.get(name, 0.0) + sum(b - a for a, b in parts) - trace.busy(parts)

    for i, r in enumerate(records):
        group = groups.get(i, [])
        ids = {s.id for s in group}
        own = tracing.self_intervals(group)
        for s in group:
            add(s.name, own[s.id])
        rest, t = [], r.start
        for s in group:
            if s.parent not in ids:  # the service's top-level spans
                rest.append((t, s.start))
                t = s.end
        rest.append((t, r.end))
        add("invocation", [(a, b) for a, b in rest if b > a])
    service = [(r.start, r.end) for r in records]
    service_s = sum(b - a for a, b in service)
    in_service = sum(idle.values())
    a, b = trace.window
    idle["no invocation"] = ((b - a) - service_s
                             - (trace.busy([(a, b)]) - trace.busy(service)))
    return {"by_name": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
            "sum_in_service_s": in_service,
            "idle_share_numerator_s": service_s - trace.busy(service),
            "service_s": service_s}


def setup_seconds(spans, t0: float) -> Dict[str, float]:
    """Seconds in each top-level span that started before the window."""
    out: Dict[str, float] = {}
    for s in spans:
        if s.start < t0 and s.parent is None:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def run(workload: str, seed: int, seconds: float, spans_on: bool, *, t_start: float,
        device="cuda", root=None) -> Dict:
    from repro_torch import tracing

    from portbench import harness

    tracing.drain()
    before = tracing.counters()
    if spans_on:
        tracing.enable()
    try:
        sv = harness.serve(workload, seed, seconds, True, t_start=t_start, device=device,
                           root=root or harness.PB)
    finally:
        tracing.disable()
    spans = tracing.drain()
    ctx = sv.ctx
    per_layer = {}
    for name in sv.spec.per_layer:
        v = sv.spec.reader(name).read(ctx)
        if v is not None and math.isfinite(v):
            per_layer[name] = v
    out = {"workload": workload, "seed": seed, "spans_on": spans_on, "device": sv.dev,
           "attempted": len(ctx.records), "traced": len(ctx.traced), "per_layer": per_layer,
           "counters": {k: v - before.get(k, 0) for k, v in tracing.counters().items()
                        if v != before.get(k, 0)}}
    if spans_on:
        out["spans"] = readings(spans, ctx.traced)
        out["setup"] = setup_seconds(spans, ctx.t0)
        if ctx.trace is not None:
            out["on_device"] = device_readings(ctx.trace, spans, ctx.traced,
                                               ctx.dims.layers)
            out["idle_by_span"] = idle_by_span(ctx.trace, spans, ctx.traced)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the program's spans over runs of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--spans", default="1")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as entry

    entry._environment()  # the benchmark's own: its paths, caches and threads
    t = T_START
    for s in args.seeds.split(","):
        for on in args.spans.split(","):
            print(json.dumps(run(args.workload, int(s), args.seconds, on == "1", t_start=t)),
                  flush=True)
            t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
