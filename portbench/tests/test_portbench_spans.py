"""The program's spans read against a run (``portbench/spans.py``), on the
CPU at test size: a run with the tracer on reads each host-side reading
above 0 and the read share of decode steps the mix's arithmetic gives,
and has no device trace to read; the harness's own runs, traced or not,
record no span and keep their result keys; the idle and device-operation
arithmetic on a made-up device trace."""

import time
import types

import pytest

from portbench import devtrace, harness, spans

import cpu_cells

SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cpu_cells.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny-dense.tiny-open", "tiny-dense.tiny-closed"])
def test_traced_run_reads_the_program_spans(one_thread, root, monkeypatch, workload):
    sv = {}
    serve = harness.serve

    def keep(*a, **kw):
        sv["run"] = serve(*a, **kw)
        return sv["run"]

    monkeypatch.setattr(harness, "serve", keep)
    r = spans.run(workload, SEED, 0.6, True, t_start=time.perf_counter(), device="cpu",
                  root=root)
    traced = sv["run"].ctx.traced
    s = r["spans"]
    assert r["traced"] == len(traced) > 0
    assert s["decode_launch_ms"] > 0 and s["allocator_span_us"] > 0
    steps = sum(rec.max_new for rec in traced)
    assert s["decode_steps"] == steps
    want = 100.0 * sum(rec.max_new - 1 for rec in traced) / steps
    assert s["decode_steps_read"] == pytest.approx(want, abs=1e-9)
    # set-up's warm-up and the whole window counted; each allocation reads back
    assert r["counters"]["allocator.device_reads"] > r["attempted"]
    assert r["counters"]["allocator.flush_rows"] > 0
    assert r["setup"]["engine.generate"] > 0
    # a CPU run has no device trace: nothing is read from one
    assert "on_device" not in r and "idle_by_span" not in r


@pytest.mark.parametrize("trace", [False, True])
def test_harness_runs_record_no_span(one_thread, root, trace):
    from repro_torch import tracing

    tracing.drain()
    r = harness.run("tiny-dense.tiny-open", SEED, 0.5, trace, t_start=time.perf_counter(),
                    device="cpu", root=root)
    assert tracing.drain() == []
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "generator",
                       "checks"]
    assert r["correct"]


def _span(id, name, start, end, parent=None, **attrs):
    from repro_torch.tracing import Span

    s = Span(id, name, parent, None, attrs)
    s.start, s.end = start, end
    return s


def test_idle_and_device_operations_arithmetic():
    rec = harness.Record(0, [], 2, 0.0, start=1.0, end=2.0)
    gen = _span(1, "engine.generate", 1.2, 1.9)
    spans_ = [_span(0, "allocator.allocate", 1.0, 1.1), gen,
              _span(2, "engine.decode.launch", 1.3, 1.5, gen, read=True, step=0),
              _span(3, "engine.decode.wait", 1.5, 1.6, gen, step=0),
              _span(4, "engine.decode.launch", 1.6, 1.7, gen, read=False, step=1),
              _span(5, "engine.generate", 2.1, 2.2)]  # outside the service: not read
    kernels = [("k", 1.05, 1.08), ("k", 1.35, 1.45), ("k", 1.55, 1.58), ("k", 1.62, 1.75),
               ("k", 1.95, 2.05), ("k", 2.12, 2.15)]
    trace = devtrace.DeviceTrace(kernels, (1.0, 2.5))
    dev = spans.device_readings(trace, spans_, [rec], layers=1)
    assert dev["ops_per_step"] == pytest.approx(3 / 2)
    assert dev["ops_by_name_per_step"] == [["k", 1.5]]
    assert dev["decode_attention_kept_pct"] == 0.0
    assert dev["sync_gap_ms"]["waits"] == 0  # no prefill wait here
    out = spans.idle_by_span(trace, spans_, [rec])
    got = dict(out["by_name"])
    assert got["allocator.allocate"] == pytest.approx(0.1 - 0.03)
    assert got["engine.decode.launch"] == pytest.approx(0.3 - 0.1 - 0.08)
    assert got["engine.decode.wait"] == pytest.approx(0.1 - 0.03)
    assert got["engine.generate"] == pytest.approx(0.3 - 0.05)  # own: 1.2-1.3, 1.7-1.9
    assert got["invocation"] == pytest.approx(0.1 + 0.1 - 0.05)  # 1.1-1.2, 1.9-2.0
    assert got["no invocation"] == pytest.approx(0.5 - 0.05 - 0.03)
    assert out["sum_in_service_s"] == pytest.approx(out["idle_share_numerator_s"])
    assert out["service_s"] == pytest.approx(1.0)
    r = spans.readings(spans_, [rec])
    assert r["decode_steps"] == 2 and r["decode_steps_read"] == 50.0
    assert r["decode_launch_ms"] == pytest.approx(150.0)
    assert r["allocator_span_us"] == pytest.approx(1e5)


def test_sync_gap_reads_the_wait_against_its_last_operation():
    rec = harness.Record(0, [], 1, 0.0, start=0.0, end=1.0)
    spans_ = [_span(0, "engine.prefill.wait", 0.2, 0.5),
              _span(1, "engine.prefill.wait", 0.6, 0.6005),  # too short to have blocked
              _span(2, "engine.prefill.wait", 0.7, 0.8)]  # nothing in the trace
    kernels = [("k", 0.1, 0.3), ("k", 0.25, 0.49), ("k", 0.3, 0.4), ("k", 0.6001, 0.6002)]
    gap = spans.device_readings(devtrace.DeviceTrace(kernels, (0.0, 1.0)), spans_, [rec],
                                layers=1)["sync_gap_ms"]
    assert gap["waits"] == 2 and gap["with_ops"] == 1
    assert gap["median"] == gap["max"] == pytest.approx(10.0)


def test_device_operations_a_decode_step_reader():
    read = harness.load_module(
        harness.PB / "metrics" / "engine.decode_device_ops_per_step.classify.py").read
    # decode phases 1.5-1.9 (2 steps) and 2.6-2.8 (1 step), from decode_s at t_gen
    recs = [harness.Record(0, [], 2, 0.0, start=1.0, t_alloc=1.1, t_gen=1.9, end=2.0,
                           prefill_s=0.3, decode_s=0.4),
            harness.Record(1, [], 1, 0.0, start=2.2, t_alloc=2.3, t_gen=2.8, end=2.9,
                           prefill_s=0.2, decode_s=0.2)]
    kernels = [("k", 1.2, 1.3), ("k", 1.45, 1.55),  # the prefill's, one running on
               ("k", 1.6, 1.62), ("k", 1.7, 1.72), ("k", 1.85, 1.95),  # first phase
               ("k", 1.95, 1.96),  # the feedback's
               ("k", 2.65, 2.66), ("k", 2.7, 2.71), ("k", 2.85, 2.86)]
    trace = devtrace.DeviceTrace(kernels, (1.0, 3.0))
    ctx = types.SimpleNamespace(trace=trace, traced=recs)
    assert read(ctx) == pytest.approx(5 / 3)
    assert read(types.SimpleNamespace(trace=None, traced=recs)) is None
