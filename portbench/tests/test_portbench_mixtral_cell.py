"""The expert cell with dropless routing on the CPU at test size, in a
copy made as ``cpu_cells.make`` makes one, from new files only: a tiny
Mixtral-shaped configuration whose reference is ``decoder_dropless`` and
whose port keys drop no assignment. The dropless reference against the
port in float32 (teacher-forced prefill and ring decode, and the serving
engine's own tokens), its routed mode against its top-k mode, the float8
control; a whole run of the tiny cell judged correct; the roofline
reader of the expert products. The committed cell's files load."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import calibrate, check, harness, work
from portbench.references import decoder, decoder_dropless

import cpu_cells

CFG = dict(cpu_cells.TINY["tiny-moe"], reference="decoder_dropless",
           port={"family": "moe", "mlp_type": "swiglu", "moe_capacity_factor": None})
CELL = "tiny-dropless.tiny-open"
SEED = 2**31 + 9


def make(dst):
    """``cpu_cells.make``'s copy with the dropless configuration and its
    cell added as new files and entries."""
    root = cpu_cells.make(dst)
    (root / "configs" / "tiny-dropless.json").write_text(json.dumps(
        dict(CFG, name="tiny-dropless", source="test size")))
    cell = cpu_cells.cell("tiny-dropless", "tiny-open", check={
        "served_tokens": 40, "logit_gap": 0.08, "route_deficit": 0.25})
    (root / "cells" / f"{CELL}.json").write_text(json.dumps(cell))
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dropless", "source": "test size",
                             "file": "portbench/configs/tiny-dropless.json", "reduced": [],
                             "why": "test size"})
    bench["workloads"].append({"name": CELL, "config": "tiny-dropless", "traffic": "tiny-open",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "tiny-moe.tiny-open" in m["workloads"]:
            m["workloads"].append(CELL)
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(tmp_path_factory.mktemp("bench"))


def _tree(t, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in t.items()}


def _teacher_forced(lens, max_new, seed):
    """The port's float32 logits at each generated position (prefill, then
    decode steps through a ring), its recorded routing, and the sequence."""
    from repro_torch.models.model import forward_decode, forward_prefill

    cfg = dict(CFG, name="t", source="test")
    w = decoder.make_weights(cfg, seed, "cpu")
    port = harness.port_config(dict(cfg, torch_dtype="float32"))
    assert port.moe_capacity_factor is None
    rng = np.random.default_rng(seed)
    S = max(lens)
    W = min(S + max_new, cfg["sliding_window"])
    prompts = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        prompts[i, S - n:] = rng.integers(1, cfg["vocab_size"], n)
    teach = torch.from_numpy(rng.integers(1, cfg["vocab_size"], (len(lens), max_new)))
    got = []
    with torch.no_grad(), harness.recorded_routes() as calls:
        lg, cache = forward_prefill(_tree(w, lambda x: x.float()), port,
                                    torch.from_numpy(prompts), cache_window=W)
        got.append(lg)
        for j in range(max_new):
            lg, cache = forward_decode(_tree(w, lambda x: x.float()), port,
                                       teach[:, j].to(torch.int32), cache)
            got.append(lg)
    seq = torch.cat([torch.from_numpy(prompts), teach[:, :max_new - 1]], dim=1)
    rec = SimpleNamespace(batch=len(lens), padded_len=S, max_new=max_new)
    routes = check.routes(calls, cfg["num_hidden_layers"], cfg["num_experts_per_tok"], rec)
    return cfg, w, torch.stack(got[:max_new], 1), routes, (seq, S), W


@pytest.mark.parametrize("lens,max_new", [
    ((40, 10, 7), 4),  # 120 prompt tokens: pads crowd an expert past any capacity of 1.25
    ((12, 3), 3),
    ((5,), 1),
])
def test_dropless_reference_matches_the_port_in_float32(one_thread, lens, max_new):
    cfg, w, got, routes, seq, W = _teacher_forced(lens, max_new, seed=7)
    want = decoder_dropless.logits(w, cfg, [seq], W)[0]
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    routed, deficits = decoder_dropless.logits(w, cfg, [seq], W, routes=[routes])
    assert torch.equal(routed[0], want)  # the port chose the reference's own top-k
    assert deficits[0].abs().max() == 0
    if len(lens) == 3:  # the capacity reference drops what the port keeps
        capped = decoder.logits(w, cfg, [seq], W)[0]
        assert (got - capped).abs().max() > 1e-3 * want.abs().max()


def test_served_tokens_are_the_dropless_references_first(one_thread):
    """The serving engine in float32 (prefill, greedy decode through the
    ring): every served token is the reference's best at its position."""
    from repro_torch.serving.engine import ServingEngine

    cfg = dict(CFG, name="t", source="test")
    w = decoder.make_weights(cfg, 11, "cpu")
    port = harness.port_config(dict(cfg, torch_dtype="float32"))
    eng = ServingEngine(port, params=_tree(w, lambda x: x.float()), cache_window=24,
                        device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg["vocab_size"], n).tolist() for n in (30, 9, 17)]
    res = eng.generate(prompts, max_new_tokens=5)
    recs = [SimpleNamespace(batch=3, padded_len=30, max_new=5,
                            prompts=[np.asarray(p) for p in prompts], tokens=res.tokens)]
    ref = decoder_dropless.logits(w, cfg, check.sequences(recs, "cpu"), 24)
    g = check.gaps(ref, [torch.as_tensor(np.asarray(res.tokens))])
    assert g.numel() == 15 and float(g.max()) <= 1e-5


def test_given_routes_are_kept_whole_and_the_control_departs(one_thread):
    """Two disjoint pairs of experts give different logits, every
    assignment kept; the float8 control, routed the same, departs from
    the float32 reference by more than rounding."""
    cfg = dict(CFG, name="t", source="test")
    w = decoder.make_weights(cfg, 3, "cpu")
    L, S, m = cfg["num_hidden_layers"], 9, 3
    seq = torch.from_numpy(np.random.default_rng(3).integers(1, cfg["vocab_size"], (2, S + m - 1)))

    def given(pair):
        return [torch.tensor(pair).expand(2, S + m - 1, 2) for _ in range(L)]

    lo, d_lo = decoder_dropless.logits(w, cfg, [(seq, S)], 64, routes=[given((0, 1))])
    hi, d_hi = decoder_dropless.logits(w, cfg, [(seq, S)], 64, routes=[given((2, 3))])
    assert not torch.allclose(lo[0], hi[0])
    assert ((d_lo[0] > 0) | (d_hi[0] > 0)).all()
    low, _ = decoder_dropless.logits(w, cfg, [(seq, S)], 64, quant="fp8", routes=[given((0, 1))])
    assert (low[0] - lo[0]).abs().max() > 1e-3


def test_tiny_dropless_cell_runs_correct(one_thread, root):
    r = harness.run(CELL, SEED, 1.0, False, t_start=time.perf_counter(), device="cpu",
                    root=root)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert {"route_deficit", "reserve_mismatches"} <= set(r["checks"])
    assert r["checks"]["reserve_mismatches"]["value"] == 0
    spec = harness.load_spec(CELL, root)
    assert spec.config["reference"] == "decoder_dropless"
    assert harness.port_config(spec.config).moe_capacity_factor is None


def test_tiny_dropless_control_is_not_correct(one_thread, root):
    r = calibrate.readings(CELL, 5, 1.0, True, t_start=time.perf_counter(), device="cpu",
                           root=root)
    assert harness.passes(r["checks"])
    assert r["read"]["control"]["logit_gap"] > r["checks"]["logit_gap"]["limit"]


def test_traced_cpu_run_leaves_the_device_metrics_out(one_thread, root):
    r = harness.run(CELL, SEED, 1.0, True, t_start=time.perf_counter(), device="cpu",
                    root=root)
    assert not any("roofline" in m or "mfu" in m for m in r["metrics"])


def test_moe_gmm_roofline_reader_counts_prefill_and_every_step():
    spec = harness.load_spec("mixtral-8x7b-16l.classify")
    reader = spec.reader("moe_gmm_roofline.classify")
    dm = work.dims(spec.config)
    rec = SimpleNamespace(batch=4, padded_len=300, max_new=3)
    ctx = SimpleNamespace(dims=dm, traced=[rec], trace=None)
    got = list(reader.calls(ctx, rec))
    assert len(got) == dm.layers * (1 + 3)
    assert got[0] == work.moe_calls(dm, 1200) and got[-1] == work.moe_calls(dm, 4)
    assert reader.read(ctx) is None  # no device trace, nothing to read
    bound = sum(work.bound_s(c["ops"], c["bytes"]) for c in got)
    # the grouped product and the per-expert one of the decode steps
    ctx.trace = SimpleNamespace(seconds_by_name=lambda names: 2 * bound if names == (
        "moe_gmm",) else 0.0)
    assert reader.read(ctx) == pytest.approx(50.0)


def test_committed_cell_loads_as_a_dropless_expert_cell():
    spec = harness.load_spec("mixtral-8x7b-16l.classify")
    assert spec.config["reference"] == "decoder_dropless"
    cfg = harness.port_config(spec.config)
    assert cfg.moe_capacity_factor is None and cfg.family == "moe"
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts) == (16, 4096, 14336, 8)
    assert spec.cache_window == 1032
    assert "moe_gmm_roofline.classify" in spec.per_layer
    assert {"invocation_p90_ms", "tokens_per_s", "setup_s"} == set(spec.end_to_end)
