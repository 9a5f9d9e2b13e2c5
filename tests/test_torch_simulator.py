"""The port's cluster simulator against the JAX reference, on the CPU.

Both packages take the same seeded inputs:

* the function profiles, the input pool and the SLO table are equal;
* every registered scenario generates the same arrival list;
* the calendar queue pops in the reference's order on a seeded random
  schedule of pushes and pops;
* every policy of ``experiment.POLICIES`` plus the legacy allocator
  engine and the two §4.2 formulations, run on one short shared trace,
  gives ``InvocationResult`` lists equal field by field (NaN equal to
  NaN; tolerance 0);
* ``examples/serve_cluster_torch.py --device cpu`` prints the reference
  example's lines.
"""

import contextlib
import dataclasses
import importlib.util
import io
import itertools
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import baselines as JB  # noqa: E402
from repro.serving import event_queue as JQ  # noqa: E402
from repro.serving import experiment as JE  # noqa: E402
from repro.serving import profiles as JP  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
from repro_torch.serving import baselines as TB  # noqa: E402
from repro_torch.serving import event_queue as TQ  # noqa: E402
from repro_torch.serving import experiment as TE  # noqa: E402
from repro_torch.serving import profiles as TP  # noqa: E402
from repro_torch.serving import workload as TW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
POLICIES = list(TE.POLICIES) + ["shabari-legacy-engine", "shabari-one-hot",
                                "shabari-per-input-type"]
# the shared trace: 180 s at 3 requests/s (about 540 invocations)
TRACE = dict(rps=3.0, duration_s=180.0, seed=0)


def _fields(obj):
    return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def test_policy_list_equals_reference():
    assert TE.POLICIES == JE.POLICIES


def test_profiles_pool_and_slo_table_equal_reference():
    tp, jp = TP.build_profiles(), JP.build_profiles()
    tpool, jpool = TP.build_input_pool(seed=0), JP.build_input_pool(seed=0)
    assert sorted(tp) == sorted(jp)
    assert tpool == jpool
    for fn in sorted(tp):
        a, b = tp[fn], jp[fn]
        for f in ("name", "input_type", "t0", "noise_base", "noise_size_coef"):
            assert getattr(a, f) == getattr(b, f), (fn, f)
        for meta in tpool[fn]:
            for f in ("serial", "parallel", "max_parallelism", "mem_mb", "size_scale"):
                assert getattr(a, f)(meta) == getattr(b, f)(meta), (fn, f)
            ra, rb = np.random.default_rng(5), np.random.default_rng(5)
            for v in (1, 4, 32):
                assert a.exec_time(meta, v, ra, 1.5) == b.exec_time(meta, v, rb, 1.5)
                assert a.exec_and_demand(meta, v, ra) == b.exec_and_demand(meta, v, rb)
            assert TP.input_size_mb(fn, meta) == JP.input_size_mb(fn, meta)
    assert (TB.build_slo_table(tp, tpool, multiplier=1.4)
            == JB.build_slo_table(jp, jpool, multiplier=1.4))


@pytest.mark.parametrize("scenario", JW.list_scenarios())
def test_scenario_arrivals_equal_reference(scenario):
    assert TW.list_scenarios() == JW.list_scenarios()
    profiles = JP.build_profiles()
    pool = JP.build_input_pool(seed=0)
    fns = sorted(profiles)
    per_fn = {f: len(pool[f]) for f in fns}
    for seed in (0, 3):
        kw = dict(scenario=scenario, rps=3.0, duration_s=180.0, seed=seed)
        got = TW.generate_scenario(TW.ScenarioSpec(**kw), fns, per_fn)
        want = JW.generate_scenario(JW.ScenarioSpec(**kw), fns, per_fn)
        assert len(got) == len(want) > 0
        assert [_fields(a) for a in got] == [_fields(a) for a in want]


def test_calendar_queue_pops_in_reference_order():
    rng = np.random.default_rng(7)
    port, ref = TQ.CalendarQueue(bucket_s=0.5), JQ.CalendarQueue(bucket_s=0.5)
    now, seq, popped = 0.0, 0, []
    for _ in range(4000):
        if rng.random() < 0.55 or not ref:
            # a handler schedules into the future (t >= now), often
            # into the bucket being drained, sometimes at the same time
            t = now if rng.random() < 0.1 else now + float(rng.exponential(0.8))
            ev = (t, seq, int(rng.integers(100)))
            seq += 1
            port.push(ev)
            ref.push(ev)
        else:
            assert port.peek() == ref.peek()
            a, b = port.pop(), ref.pop()
            assert a == b
            now = a[0]
            popped.append(a)
        assert len(port) == len(ref)
    while ref:
        popped.append(port.pop())
        assert popped[-1] == ref.pop()
    assert not port and port.peek() is None
    assert len(popped) == seq


def _results(module, workload, policy, monkeypatch, **kw):
    # generate_trace numbers invocations from a process-wide counter;
    # start both packages' counters at 0 so the ids match
    monkeypatch.setattr(workload, "_inv_ids", itertools.count())
    return module.run_experiment(policy, keep_results=True, **TRACE, **kw)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_results_equal_reference(policy, monkeypatch):
    got = _results(TE, TW, policy, monkeypatch, device="cpu")
    want = _results(JE, JW, policy, monkeypatch)
    assert got.summary == want.summary
    assert got.container_sizes == want.container_sizes
    assert len(got.results) == len(want.results) > 500
    names = [f.name for f in dataclasses.fields(want.results[0])]
    for r, s in zip(got.results, want.results):
        diff = [n for n, a, b in zip(names, _fields(r), _fields(s)) if not _same(a, b)]
        assert not diff, (policy, r.invocation_id, {n: (getattr(r, n), getattr(s, n))
                                                    for n in diff})


def test_card_path_raises_without_a_card():
    """The entry points default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.run_experiment("shabari", rps=1.0, duration_s=10.0)


def _printed(path: Path, argv) -> str:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def test_serve_cluster_example_prints_reference_lines():
    argv = ["--quick", "--rps", "1"]
    got = _printed(ROOT / "examples" / "serve_cluster_torch.py", argv + ["--device", "cpu"])
    want = _printed(ROOT / "examples" / "serve_cluster.py", argv)
    assert got == want
    assert len(got.splitlines()) == 8 and "shabari " in got
