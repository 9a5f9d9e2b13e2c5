"""The Granite 4.0-H cell on the CPU at test size, in a copy made as
``cpu_cells.make`` makes one, from new files only: a tiny configuration
of the same shape (Mamba2 and attention layers, each followed by experts
and a shared expert) whose reference is ``granite_hybrid``. The reference
against the port in float32 (a prefill and decode steps, the serving
engine's own tokens), its routed mode, the float8 control; a whole run of
the tiny cell judged correct; the readers' arithmetic
(``work_hybrid.py``). The committed configuration and cell load."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import calibrate, check, harness, work, work_hybrid
from portbench.references import granite_hybrid

import cpu_cells

KINDS = ["mamba", "attention", "mamba", "mamba"]
CFG = {"model_type": "granitemoehybrid", "hidden_size": 64, "intermediate_size": 32,
       "shared_intermediate_size": 48, "num_hidden_layers": 4, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512, "num_local_experts": 6,
       "num_experts_per_tok": 3, "attention_bias": False, "rope_theta": 10000,
       "rms_norm_eps": 1e-05, "torch_dtype": "bfloat16", "layer_types": KINDS,
       "embedding_multiplier": 12, "residual_multiplier": 0.22,
       "attention_multiplier": 0.0625, "logits_scaling": 16, "mamba_n_heads": 4,
       "mamba_d_head": 32, "mamba_d_state": 32, "mamba_d_conv": 4, "mamba_chunk_size": 32,
       "tie_word_embeddings": True, "reference": "granite_hybrid",
       "port": {"family": "hybrid_moe", "mlp_type": "swiglu", "moe_capacity_factor": None,
                "layer_types": KINDS, "shared_d_ff": 48, "embedding_multiplier": 12.0,
                "residual_multiplier": 0.22, "attention_multiplier": 0.0625,
                "logits_scaling": 16.0, "use_rope": False, "tie_embeddings": True,
                "ssm_state": 32, "ssm_head_dim": 32, "ssm_expand": 2, "ssm_chunk": 32,
                "conv_width": 4}}
CELL = "tiny-granite.tiny-open"
SEED = 2**31 + 11
GRANITE = "granite-4.0-h-small.classify"


def make(dst):
    """``cpu_cells.make``'s copy with the tiny hybrid and its cell added as
    new files and entries, listed where the Granite cell is."""
    root = cpu_cells.make(dst)
    (root / "configs" / "tiny-granite.json").write_text(json.dumps(
        dict(CFG, name="tiny-granite", source="test size")))
    cell = cpu_cells.cell("tiny-granite", "tiny-open", check={
        "served_tokens": 40, "logit_gap": 6e-5, "route_deficit": 0.25})
    (root / "cells" / f"{CELL}.json").write_text(json.dumps(cell))
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-granite", "source": "test size",
                             "file": "portbench/configs/tiny-granite.json", "reduced": [],
                             "why": "test size"})
    bench["workloads"].append({"name": CELL, "config": "tiny-granite", "traffic": "tiny-open",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and GRANITE in m["workloads"]:
            m["workloads"].append(CELL)
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(tmp_path_factory.mktemp("bench"))


def _tree(t, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in t.items()}


def _wide(w):
    """The weights in float32, the head still a view of the embedding."""
    out = _tree(w, lambda x: x.float())
    out["lm_head"] = out["embed"].t()
    return out


def _teacher_forced(lens, max_new, seed, window):
    """The port's float32 logits at each generated position (prefill, then
    decode steps), its recorded routing, and the sequence."""
    from repro_torch.models.model import forward_decode, forward_prefill

    cfg = dict(CFG, name="t", source="test")
    w = granite_hybrid.make_weights(cfg, seed, "cpu")
    port = harness.port_config(dict(cfg, torch_dtype="float32"))
    rng = np.random.default_rng(seed)
    S = max(lens)
    prompts = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        prompts[i, S - n:] = rng.integers(1, cfg["vocab_size"], n)
    teach = torch.from_numpy(rng.integers(1, cfg["vocab_size"], (len(lens), max_new)))
    got = []
    with torch.no_grad(), harness.recorded_routes() as calls:
        lg, cache = forward_prefill(_wide(w), port, torch.from_numpy(prompts),
                                    cache_window=window)
        got.append(lg)
        for j in range(max_new):
            lg, cache = forward_decode(_wide(w), port, teach[:, j].to(torch.int32), cache)
            got.append(lg)
    seq = torch.cat([torch.from_numpy(prompts), teach[:, :max_new - 1]], dim=1)
    rec = SimpleNamespace(batch=len(lens), padded_len=S, max_new=max_new)
    routes = check.routes(calls, cfg["num_hidden_layers"], cfg["num_experts_per_tok"], rec)
    return cfg, w, torch.stack(got[:max_new], 1), routes, (seq, S)


@pytest.mark.parametrize("lens,max_new,window", [
    ((45, 10, 7), 4, 64),  # two SSD chunks, the second ragged; pads enter the state
    ((12, 3), 3, 8),  # the ring wraps under the decode steps
    ((2,), 2, 16),  # a prompt shorter than the conv window
])
def test_reference_matches_the_port_in_float32(one_thread, lens, max_new, window):
    # float32 on both sides over the same bf16 weights: the SSD's chunk
    # sizes (the port's 32 against the reference's 64) and the summation
    # order differ, rounding alone
    cfg, w, got, routes, seq = _teacher_forced(lens, max_new, 7, window)
    want = granite_hybrid.logits(w, cfg, [seq], window)[0]
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    routed, deficits = granite_hybrid.logits(w, cfg, [seq], window, routes=[routes])
    assert torch.equal(routed[0], want)  # the port chose the reference's own top-k
    assert deficits[0].abs().max() == 0


def test_served_tokens_are_the_references_first(one_thread):
    """The serving engine in float32 (prefill, greedy decode): every served
    token is the reference's best at its position."""
    from repro_torch.serving.engine import ServingEngine

    cfg = dict(CFG, name="t", source="test")
    w = granite_hybrid.make_weights(cfg, 11, "cpu")
    port = harness.port_config(dict(cfg, torch_dtype="float32"))
    eng = ServingEngine(port, params=_wide(w), cache_window=40, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg["vocab_size"], n).tolist() for n in (35, 9, 17)]
    res = eng.generate(prompts, max_new_tokens=5)
    recs = [SimpleNamespace(batch=3, padded_len=35, max_new=5,
                            prompts=[np.asarray(p) for p in prompts], tokens=res.tokens)]
    ref = granite_hybrid.logits(w, cfg, check.sequences(recs, "cpu"), 40)
    g = check.gaps(ref, [torch.as_tensor(np.asarray(res.tokens))])
    assert g.numel() == 15 and float(g.max()) <= 1e-7
    assert len({t for row in res.tokens for t in row}) > 3  # not the prompt's last token echoed


def test_given_routes_change_the_logits_and_the_control_departs(one_thread):
    cfg = dict(CFG, name="t", source="test")
    w = granite_hybrid.make_weights(cfg, 3, "cpu")
    L, S, m = cfg["num_hidden_layers"], 9, 3
    seq = torch.from_numpy(np.random.default_rng(3).integers(1, cfg["vocab_size"], (2, S + m - 1)))

    def given(ids):
        return [torch.tensor(ids).expand(2, S + m - 1, 3) for _ in range(L)]

    lo, d_lo = granite_hybrid.logits(w, cfg, [(seq, S)], 64, routes=[given((0, 1, 2))])
    hi, d_hi = granite_hybrid.logits(w, cfg, [(seq, S)], 64, routes=[given((3, 4, 5))])
    assert not torch.allclose(lo[0], hi[0])
    assert ((d_lo[0] > 0) | (d_hi[0] > 0)).all()
    low, _ = granite_hybrid.logits(w, cfg, [(seq, S)], 64, quant="fp8",
                                   routes=[given((0, 1, 2))])
    assert (low[0] - lo[0]).abs().max() > 1e-2 * lo[0].abs().max()


def test_tiny_granite_cell_runs_correct(one_thread, root):
    r = harness.run(CELL, SEED, 1.0, False, t_start=time.perf_counter(), device="cpu",
                    root=root)
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["reserve_mismatches"]["value"] == 0
    assert r["checks"]["logit_gap"]["tokens"] >= 40


def test_tiny_granite_control_is_not_correct(one_thread, root):
    r = calibrate.readings(CELL, 5, 1.0, True, t_start=time.perf_counter(), device="cpu",
                           root=root)
    assert harness.passes(r["checks"])
    assert r["read"]["control"]["logit_gap"] > r["checks"]["logit_gap"]["limit"]


def test_traced_cpu_run_leaves_the_device_metrics_out(one_thread, root):
    r = harness.run(CELL, SEED, 1.0, True, t_start=time.perf_counter(), device="cpu",
                    root=root)
    assert not any("roofline" in m or "mfu" in m for m in r["metrics"])


def test_ssd_call_by_hand():
    hm = work_hybrid.dims(CFG)
    H, P, N = 4, 32, 32
    got = work_hybrid.ssd_call(hm, 2, 40)  # one whole chunk of 32, then 8 positions
    pairs = 32 * 33 // 2 + 8 * 9 // 2
    assert got["ops"] == 2 * (2 * pairs * (N + H * P) + 4 * 40 * N * H * P)
    assert got["bytes"] == 2 * (40 * (2 * H * P * 2 + H * 4 + 2 * N * 2) + H * P * N * 4)


def test_hybrid_flops_count_each_layer_kind():
    """A prefill counts attention on the attention layers alone and the
    experts (top-k and shared) on every layer."""
    hm = work_hybrid.dims(CFG)
    dm, B, S, D = hm.base, 2, 10, 64
    T = B * S
    mamba = 2 * T * (D * hm.proj + 4 * hm.conv_dim + hm.d_inner * D)
    mamba += work_hybrid.ssd_call(hm, B, S)["ops"]
    attn = 2 * T * (D * (64 + 2 * 32) + 64 * D) + 4 * 4 * 16 * B * work.prefill_pairs(S, None)
    ffn = 2 * T * (D * 6 + 3 * 3 * D * 32 + 3 * D * 48)
    head = 2 * B * D * 512
    assert work_hybrid.prefill_flops(hm, B, S) == pytest.approx(
        3 * mamba + attn + 4 * ffn + head, rel=1e-12)
    step = work_hybrid.decode_flops(hm, 1, 12, 8)
    assert step == pytest.approx(
        3 * (2 * (D * hm.proj + 4 * hm.conv_dim + hm.d_inner * D) + 4 * hm.d_inner * 32)
        + 2 * (D * (64 + 2 * 32) + 64 * D) + 4 * 4 * 16 * 9
        + 4 * 2 * (D * 6 + 3 * 3 * D * 32 + 3 * D * 48) + 2 * D * 512, rel=1e-12)


def test_readers_of_the_granite_cell():
    spec = harness.load_spec(GRANITE)
    hm = work_hybrid.dims(spec.config)
    assert (hm.mamba_layers, hm.attention_layers, hm.d_inner, hm.proj) == (36, 4, 8192, 16768)
    rec = SimpleNamespace(batch=8, padded_len=1000, max_new=4, failed=False)
    ssd = spec.reader("ssd_scan_roofline.classify")
    assert len(list(ssd.calls(hm, rec))) == 36
    ctx = SimpleNamespace(spec=spec, dims=work.dims(spec.config), traced=[rec], trace=None,
                          cache_window=spec.cache_window)
    assert ssd.read(ctx) is None  # no device trace, nothing to read
    bound = sum(work.bound_s(c["ops"], c["bytes"]) for c in ssd.calls(hm, rec))
    ctx.trace = SimpleNamespace(seconds_by_name=lambda names: 4 * bound, window_s=10.0)
    assert ssd.read(ctx) == pytest.approx(25.0)
    mfu = spec.reader("model.mfu.hybrid.classify").read(ctx)
    ops = work_hybrid.invocation_flops(hm, 8, 1000, 4, spec.cache_window)
    assert mfu == pytest.approx(100 * ops / work.PEAK_FLOPS / 10.0)
    # a configuration without Mamba2 layers reads nothing
    qwen = SimpleNamespace(spec=harness.load_spec("qwen2.5-3b.classify"), traced=[rec],
                           trace=ctx.trace, cache_window=1032)
    assert ssd.read(qwen) is None


def test_committed_granite_cell_loads():
    spec = harness.load_spec(GRANITE)
    assert spec.config["reference"] == "granite_hybrid" and spec.config["reduced"] == []
    cfg = harness.port_config(spec.config)
    assert cfg.family == "hybrid_moe" and cfg.moe_capacity_factor is None
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.shared_d_ff) == (40, 4096, 768, 1536)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.d_inner, cfg.ssm_heads) == (
        72, 10, 8192, 128)
    # the published heads x head_dim is the port's expand x d_model
    assert cfg.d_inner == spec.config["mamba_n_heads"] * spec.config["mamba_d_head"]
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert not cfg.use_rope and cfg.attention_multiplier == 1 / 128
    assert cfg.param_count() == 32_207_337_984
    assert spec.cache_window == 1032
    assert {"ssd_scan_roofline.classify", "model.mfu.hybrid.classify",
            "moe_gmm_roofline.classify"} <= set(spec.per_layer)
    assert "model.mfu.classify" not in spec.per_layer
    assert "decode_attention_roofline.classify" not in spec.per_layer
    assert {"invocation_p90_ms", "tokens_per_s", "setup_s"} == set(spec.end_to_end)
