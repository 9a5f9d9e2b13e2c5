"""The port's tracer (``repro_torch.tracing``) and the spans and counters
the serving loop records: off records nothing; nesting, parents and the
invocation id; a reduced dense engine's prefill and decode spans against
its own timings; the allocator's flush rows; the kernels' build span and
counters (with a stand-in for nvcc); ``ops.launch_counts`` on the
tracer's counters; ``launch/serve.py --trace`` read back."""

import json
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core import Featurizer, Observation, ResourceAllocator  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


@pytest.fixture
def spans_on():
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


@pytest.fixture(scope="module")
def engine():
    return ServingEngine(get_reduced_config("qwen2.5-3b"), cache_window=64, device="cpu")


def _delta(before, name):
    return tracing.counters().get(name, 0) - before.get(name, 0)


def test_off_records_nothing_and_returns_one_object():
    tracing.drain()
    a = tracing.span("x", step=1)
    b = tracing.span("y", invocation=3)
    assert a is b is tracing.OFF
    with a as s:
        s.set(rows=2)
        with b:
            pass
    assert tracing.drain() == []


def test_nesting_parents_invocation_and_self_time(spans_on):
    with tracing.span("invocation", invocation=7) as root:
        with tracing.span("a", k=1) as a:
            time.sleep(0.002)
            with tracing.span("a.inner") as inner:
                time.sleep(0.002)
            a.set(done=True)
        time.sleep(0.001)
        with tracing.span("b") as b:
            time.sleep(0.001)
    with tracing.span("other") as other:
        pass
    spans = tracing.drain()
    assert [s.name for s in spans] == ["invocation", "a", "a.inner", "b", "other"]
    assert root.parent is None and other.parent is None
    assert a.parent == b.parent == root.id and inner.parent == a.id
    assert [s.invocation for s in spans] == [7, 7, 7, 7, None]
    assert a.attrs == {"k": 1, "done": True}
    assert all(s.start <= s.end for s in spans)
    assert root.start <= a.start and inner.end <= a.end and b.end <= root.end
    own = tracing.self_intervals(spans)
    for s, kids in ((root, (a, b)), (a, (inner,)), (inner, ()), (b, ())):
        got = sum(e - t for t, e in own[s.id])
        assert got == pytest.approx(s.seconds - sum(k.seconds for k in kids), abs=1e-9)
    assert own[a.id] == [(a.start, inner.start), (inner.end, a.end)]
    assert tracing.drain() == []


@pytest.mark.parametrize("k", [1, 4])
def test_generate_spans_and_counters(spans_on, engine, k):
    before = tracing.counters()
    res = engine.generate([[5, 6, 7], [8, 9, 10, 11, 12]], max_new_tokens=k)
    spans = tracing.drain()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (call,) = by["engine.generate"]
    assert call.attrs == {"batch": 2, "max_new": k, "padded": 5}
    assert len(by["engine.prefill.launch"]) == len(by["engine.prefill.wait"]) == 1
    launches, waits = by["engine.decode.launch"], by["engine.decode.wait"]
    assert [s.attrs for s in launches] == [{"step": j, "read": j < k - 1} for j in range(k)]
    assert [s.attrs["step"] for s in waits] == list(range(-1, k))
    assert all(s.parent == call.id for s in launches + waits)
    # the steps and the unread one are the spans' facts; no counter repeats them
    assert tracing.counters() == before
    decode = sum(s.seconds for s in launches + waits)
    assert decode == pytest.approx(res.decode_s, rel=0.01)
    assert len(res.tokens[0]) == k


def test_allocator_spans_and_flush_rows(spans_on):
    feat = Featurizer()
    alloc = ResourceAllocator(vcpu_confidence=2, mem_confidence=4, device="cpu")
    before = tracing.counters()
    fed = 0
    for i in range(9):
        fn = f"f{i % 2}"
        x = feat.extract(fn, "request", {"prompt_tokens": 10 + i, "batch": 1,
                                         "max_new_tokens": 4, "image_tiles": 0,
                                         "audio_seconds": 0})
        a = alloc.allocate(fn, x)
        alloc.feedback(fn, x, Observation(
            exec_time_s=0.1, slo_s=0.2, alloc_vcpus=a.vcpus, max_vcpus_used=2,
            alloc_mem_mb=a.mem_mb, max_mem_used_mb=300.0))
        fed += 1
    alloc.flush()
    spans = tracing.drain()
    names = [s.name for s in spans]
    for n in ("allocator.featurize", "allocator.allocate", "allocator.feedback"):
        assert names.count(n) == 9
    flushes = [s for s in spans if s.name == "allocator.flush"]
    assert _delta(before, "allocator.flush_rows") == fed
    assert sum(s.attrs["rows"] for s in flushes) == fed
    assert len(flushes) > 1
    assert all(s.attrs["passes"] >= 1 for s in flushes)
    predicts = [s for s in spans if s.name == "allocator.predict"]
    assert predicts and all(s.parent is not None for s in predicts)
    assert _delta(before, "allocator.device_reads") == len(predicts)
    alloc.flush()  # nothing queued: no flush is recorded
    assert tracing.drain() == [] and _delta(before, "allocator.flush_rows") == fed


def test_kernel_build_span_and_counters(spans_on, tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
                    "print('ptxas info    : Used 40 registers')\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    before = tracing.counters()
    logs = _build.build(("flash_attention", "ssd_scan"))
    assert set(logs) == {"flash_attention", "ssd_scan"}
    assert all("Used 40 registers" in v for v in logs.values())
    assert _delta(before, "kernels.builds") == 2
    assert _build.build(("flash_attention",)) == {}  # built: nothing to do
    (sp,) = tracing.drain()
    assert sp.name == "kernels.build" and sp.attrs == {"kernels": ["flash_attention",
                                                                   "ssd_scan"]}
    assert not hasattr(_build, "build_logs")


def test_launch_counts_read_the_tracer():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_gmm": 0}
    tracing.count("allocator.flush_rows", 0)
    keep = tracing.counters()["allocator.flush_rows"]
    for name, n in (("decode_attention", 36), ("flash_attention", 2),
                    ("decode_attention", 36), ("moe_gmm", 3)):
        for _ in range(n):
            tracing.count(f"kernels.launches.{name}")
    got = ops.launch_counts()
    assert list(got) == ["flash_attention", "decode_attention", "ssd_scan", "moe_gmm"]
    assert got == {"flash_attention": 2, "decode_attention": 72, "ssd_scan": 0, "moe_gmm": 3}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    assert tracing.counters()["allocator.flush_rows"] == keep


def test_serve_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "out" / "spans.json"  # a directory made on the way
    served = serve_mod.main(["--reduced", "--device", "cpu", "--requests", "3",
                             "--max-new", "3", "--trace", str(path)])
    assert tracing.span("x") is tracing.OFF and tracing.drain() == []
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    roots = [e for e in spans if e["name"] == "invocation"]
    assert [e["args"]["invocation"] for e in roots] == [0, 1, 2]
    assert sum(e["name"] == "engine.decode.launch" for e in spans) == 3 * 3
    assert all(e["dur"] >= 0 and e["args"]["invocation"] in (0, 1, 2) for e in spans)
    counts = {e["name"]: e["args"]["value"] for e in events if e["ph"] == "C"}
    assert counts["allocator.flush_rows"] >= 2 and counts["allocator.device_reads"] >= 3
    decode = [e for e in spans if e["name"].startswith("engine.decode.")]
    for r, root in zip(served, roots):
        i = root["args"]["invocation"]
        mine = sum(e["dur"] for e in decode if e["args"]["invocation"] == i)
        assert mine / 1e6 == pytest.approx(r.result.decode_s, rel=0.01)
    assert np.isfinite([e["ts"] for e in events]).all()
