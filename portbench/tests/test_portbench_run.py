"""Whole runs on the CPU at test size, with the look for a card skipped:
the result line's shape, a sound run that comes out correct, the control
that does not, and the faults a serving cell can have, each planted in
the program underneath and each coming out not correct; for the expert
cell also a routing fault, a route record that does not fit, and the
checks a dense cell keeps as they were. (One card: no exchange between
chips to leave out.)"""

import dataclasses
import json
import time
from collections import Counter

import pytest

from portbench import calibrate, harness

import cpu_cells

DENSE = "tiny-dense.tiny-open"
MOE = "tiny-moe.tiny-open"
SEED = 2**31 + 9


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cpu_cells.make(tmp_path_factory.mktemp("bench"))


def _run(root, workload=DENSE, seed=SEED, trace=False):
    return harness.run(workload, seed, 1.0, trace, t_start=time.perf_counter(), device="cpu",
                       root=root)


@pytest.mark.parametrize("workload", sorted(cpu_cells.CELLS))
def test_result_line_shape(one_thread, root, workload):
    r = _run(root, workload)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    json.loads(json.dumps(r, allow_nan=False))
    assert r["attempted"] > 0 and r["failed"] == 0
    spec = harness.load_spec(workload, root)
    assert set(r["metrics"]) == set(spec.end_to_end)
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    for c in r["checks"].values():
        assert {"value", "limit"} <= set(c)


@pytest.mark.parametrize("workload,metrics", [
    ("tiny-dense.tiny-closed", {"engine.prefill_ms_per_ktok.longdoc"}),
    (DENSE, {"allocator.decide_us", "engine.decode_step_ms.classify"}),
])
def test_traced_run_reports_the_host_side_per_layer_metrics(one_thread, root, workload, metrics):
    r = _run(root, workload, trace=True)
    assert metrics <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] > 0 for m in metrics)
    # a CPU run has no device trace: the device readers find nothing and say nothing
    assert not any("roofline" in m or "mfu" in m or "idle" in m for m in r["metrics"])


@pytest.mark.parametrize("seed", [SEED, 2**33 + 4])
def test_closed_loop_serves_whole_passes(one_thread, root, seed):
    sv = harness.serve("tiny-dense.tiny-closed", seed, 0.3, False, t_start=time.perf_counter(),
                       device="cpu", root=root)
    n = sv.spec.mix["documents"]
    recs = sv.ctx.records
    assert len(recs) >= n and len(recs) % n == 0
    shapes = Counter((r.padded_len, r.max_new) for r in recs)
    assert set(shapes.values()) == {len(recs) // n}
    assert recs[-1].t_gen - sv.ctx.t0 >= 0.3


@pytest.mark.parametrize("seed", [SEED, 5])
def test_sound_run_is_correct_and_the_control_is_not(one_thread, root, seed):
    r = calibrate.readings(DENSE, seed, 1.0, True, t_start=time.perf_counter(), device="cpu",
                           root=root)
    limit = r["checks"]["logit_gap"]["limit"]
    assert harness.passes(r["checks"])
    assert r["read"]["logit_gap"] == r["checks"]["logit_gap"]["value"]
    assert r["read"]["control"]["logit_gap"] > limit


def _faulty(monkeypatch, fault):
    from repro_torch.core import allocator as A
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E

    gen = E.ServingEngine.generate
    if fault == "state_unchanged":  # the decode step writes no K/V into the ring
        monkeypatch.setattr(M, "ring_write", lambda buf, new, pos: buf)
    elif fault == "token_altered":
        def altered(self, prompts, **kw):
            res = gen(self, prompts, **kw)
            res.tokens[-1][-1] = (res.tokens[-1][-1] + 1) % self.cfg.vocab_size
            return res
        monkeypatch.setattr(E.ServingEngine, "generate", altered)
    elif fault == "half_batch":  # the back half of the rows copies the front half's answer
        def half(self, prompts, **kw):
            k = (len(prompts) + 1) // 2
            res = gen(self, prompts[:k], **kw)
            res.tokens = [res.tokens[i % k] for i in range(len(prompts))]
            return res
        monkeypatch.setattr(E.ServingEngine, "generate", half)
    elif fault == "allocation_altered":
        alloc = A.ResourceAllocator.allocate

        def altered_alloc(self, *a, **kw):
            out = alloc(self, *a, **kw)
            return dataclasses.replace(out, vcpus=out.vcpus % 32 + 1)
        monkeypatch.setattr(A.ResourceAllocator, "allocate", altered_alloc)


@pytest.mark.parametrize("fault,check", [
    ("state_unchanged", "logit_gap"),
    ("token_altered", "logit_gap"),
    ("half_batch", "logit_gap"),
    ("allocation_altered", "allocation_mismatches"),
])
def test_fault_comes_out_not_correct(one_thread, root, monkeypatch, fault, check):
    _faulty(monkeypatch, fault)
    r = _run(root)
    assert r["correct"] is False
    c = r["checks"][check]
    assert c["value"] is None or c["value"] > c["limit"]


@pytest.mark.parametrize("fault,check", [
    ("state_unchanged", "logit_gap"),
    ("token_altered", "reserve_mismatches"),
    ("half_batch", "reserve_mismatches"),
    ("neighbour_router", "route_deficit"),
])
def test_expert_cell_fault_comes_out_not_correct(one_thread, root, monkeypatch, fault, check):
    if fault == "neighbour_router":
        with calibrate.neighbour_router():
            r = _run(root, MOE)
    else:
        _faulty(monkeypatch, fault)
        r = _run(root, MOE)
    assert r["correct"] is False
    c = r["checks"][check]
    assert c["value"] is None or c["value"] > c["limit"]


@pytest.mark.parametrize("seed", [SEED, 5, 13])
def test_bf16_expert_run_with_flipped_choices_is_correct(one_thread, root, seed):
    """bfloat16 flips some near-tied choices against the float32 reference
    (each of these seeds does); routed as the program routed, the run is
    correct, and the control still is not."""
    r = calibrate.readings(MOE, seed, 1.0, True, t_start=time.perf_counter(), device="cpu",
                           root=root)
    assert r["read"]["route_flip_pct"] > 0
    assert harness.passes(r["checks"])
    assert r["checks"]["reserve_mismatches"]["value"] == 0
    assert 0 < r["read"]["route_deficit"] == r["checks"]["route_deficit"]["value"]
    assert r["read"]["control"]["logit_gap"] > r["checks"]["logit_gap"]["limit"]


def test_bf16_router_choices_stay_near_ties(one_thread, root):
    """Router logits in bfloat16 (hidden state, router and product), as
    the published model computes them, choose the float32 reference's
    top-k or a near-tie of it: the run is correct."""
    with calibrate.bf16_router():
        r = _run(root, MOE, seed=5)
    c = r["checks"]["route_deficit"]
    assert 0 < c["value"] < c["limit"]
    assert r["correct"] is True


def test_one_altered_served_token_is_one_reserve_mismatch(one_thread, root):
    sv = harness.serve(MOE, SEED, 1.0, False, t_start=time.perf_counter(), device="cpu",
                       root=root)
    longest = max(sv.ctx.records, key=lambda r: (r.batch * r.padded_len, r.max_new))
    longest.tokens[0][-1] = (longest.tokens[0][-1] + 1) % sv.spec.config["vocab_size"]
    checks = harness.judge(sv)
    assert checks["reserve_mismatches"]["value"] == 1
    assert not harness.passes(checks)


@pytest.mark.parametrize("cut", ["count", "shape"])
def test_route_record_that_does_not_fit_raises(one_thread, root, monkeypatch, cut):
    serve_again = harness.serve_again

    def cut_short(sv, recs):
        out = serve_again(sv, recs)
        toks, calls = out[0]
        if cut == "count":
            calls.pop()
        else:
            calls[0] = calls[0][1:]
        return out

    monkeypatch.setattr(harness, "serve_again", cut_short)
    with pytest.raises(ValueError, match="route record"):
        _run(root, MOE)


def test_dense_cell_keeps_its_checks_and_serves_nothing_again(one_thread, root, monkeypatch):
    def never(sv, recs):
        raise AssertionError("a dense cell served again")

    monkeypatch.setattr(harness, "serve_again", never)
    r = _run(root, DENSE)
    assert list(r["checks"]) == ["failed_invocations", "malformed_invocations",
                                 "allocation_mismatches", "logit_gap"]
    assert [list(c) for c in r["checks"].values()] == [
        ["value", "limit"]] * 3 + [["value", "limit", "tokens", "invocations"]]
    assert r["correct"] is True


def test_expert_cell_without_a_route_deficit_limit_fails_at_load(tmp_path):
    root = cpu_cells.make(tmp_path)
    path = root / "cells" / f"{MOE}.json"
    cell = json.loads(path.read_text())
    del cell["check"]["route_deficit"]
    path.write_text(json.dumps(cell))
    with pytest.raises(ValueError, match="check.route_deficit"):
        harness.load_spec(MOE, root)
    harness.load_spec(DENSE, root)
