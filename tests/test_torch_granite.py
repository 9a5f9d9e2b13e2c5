"""The port's hybrid_moe path (IBM Granite 4.0-H) against its plain
reference, ``portbench/references/granite_hybrid.py``, on the CPU.

The reference package has no model of Granite, so the parity held here is
the benchmark's own reference (plain torch in float32, its own chunked
SSD, no kernel of the port), on its seeded random weights taken to
float32 on both sides, at a reduced size of the same shape: d 256, 10
layers with the one attention layer at index 5, 8 experts top-3 and a
shared expert, Mamba2 at N = P = 32 and chunk 32.

* ``forward_prefill`` and 4 ``forward_decode`` steps against the
  reference's full forward, on the logits of every generated position,
  within 2e-5 x max(|ref|): both sides compute in float32 over the same
  weights and differ in the order of their sums alone (the SSD's chunks,
  32 in the port against the reference's 64; a decode step's one-step
  recurrence against the chunked form; the dropless experts' sums).
* One ``moe.route`` call per layer per forward, in the shapes
  ``portbench/check.py``'s ``routes`` takes; the reference routed by them
  gives its own logits.
* ``ops.ssd_scan`` at sequence lengths that are not a multiple of the
  chunk against ``ref.ssd_scan_sequential_ref``: y and the final state
  (the tail is padded with rows that leave the state as it was).
* ``ops.flash_attention`` and ``ops.decode_attention`` with a softmax
  ``scale`` on the plain path; the default stays 1/sqrt(D).
* The published config: 32,207,337,984 parameters (32.21 B), the layer
  pattern, the registry and the launcher.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import PORT_ARCH_IDS, get_config, get_reduced_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import kv_cache as KV  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    count_params_analytic,
    forward_decode,
    forward_prefill,
)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-4.0-h-small"
F32_REL = 2e-5  # float32 on both sides: summation order alone
KINDS = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4


def _reference():
    path = ROOT / "portbench" / "references" / "granite_hybrid.py"
    spec = importlib.util.spec_from_file_location("granite_hybrid_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _pair():
    """The test-size config for the port (float32) and, under the
    published keys, for the reference."""
    cfg = dataclasses.replace(
        get_reduced_config(ARCH), num_layers=10, layer_types=tuple(KINDS), d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=128, num_experts=8,
        experts_per_token=3, shared_d_ff=192, ssm_state=32, ssm_head_dim=32, ssm_expand=1,
        ssm_chunk=32, attention_multiplier=1 / 64, dtype="float32")
    hf = {"hidden_size": 256, "num_hidden_layers": 10, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 64, "intermediate_size": 128,
          "shared_intermediate_size": 192, "vocab_size": cfg.vocab_size,
          "num_local_experts": 8, "num_experts_per_tok": 3, "layer_types": KINDS,
          "rms_norm_eps": 1e-5, "embedding_multiplier": 12, "residual_multiplier": 0.22,
          "attention_multiplier": 1 / 64, "logits_scaling": 16, "mamba_n_heads": 8,
          "mamba_d_head": 32, "mamba_d_state": 32, "mamba_d_conv": 4, "mamba_chunk_size": 32}
    return cfg, hf


def _wide(w):
    def each(t):
        return {k: each(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    out = each(w)
    out["lm_head"] = out["embed"].t()
    return out


@pytest.mark.parametrize("lens,window", [((45, 20, 7), 64), ((33,), 36), ((3, 2), 8)])
def test_prefill_and_decode_match_the_reference(lens, window):
    """Prompts left-padded to the longest (pads enter the Mamba2 state),
    prefilled at any length, then 4 teacher-forced decode steps; the ring
    wraps where the window is shorter than the sequence."""
    cfg, hf = _pair()
    w = REF.make_weights(hf, 1, "cpu")
    rng = np.random.default_rng(1)
    S, steps = max(lens), 4
    prompts = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        prompts[i, S - n:] = rng.integers(1, cfg.vocab_size, n)
    teach = torch.from_numpy(rng.integers(1, cfg.vocab_size, (len(lens), steps)))
    params = _wide(w)
    with torch.no_grad():
        lg, cache = forward_prefill(params, cfg, torch.from_numpy(prompts), cache_window=window)
        got = [lg]
        for j in range(steps):
            lg, cache = forward_decode(params, cfg, teach[:, j].to(torch.int32), cache)
            got.append(lg)
    seq = torch.cat([torch.from_numpy(prompts), teach], dim=1)
    want = REF.logits(w, hf, [(seq, S)], window)[0]
    got = torch.stack(got, 1)
    assert got.shape == want.shape == (len(lens), steps + 1, cfg.vocab_size)
    assert float((got - want).abs().max()) <= F32_REL * float(want.abs().max())
    # the cache keeps K/V for the attention layer alone, SSD / conv state for the Mamba2 ones
    assert cache["k"].shape[0] == 1 and cache["ssd"].shape[0] == cache["conv"].shape[0] == 9


def test_one_route_call_a_layer_a_forward_in_the_checks_shapes():
    """The shared expert never calls the router: a prefill and each decode
    step call it once a layer, over B x S rows, then B; the reference
    routed by the recorded choices gives its own logits, deficit 0."""
    cfg, hf = _pair()
    w = REF.make_weights(hf, 2, "cpu")
    params = _wide(w)
    B, S, m = 2, 40, 3
    toks = torch.from_numpy(np.random.default_rng(2).integers(1, cfg.vocab_size, (B, S)))
    calls = []
    inner = MOE.route

    def recording(p, c, xt):
        out = inner(p, c, xt)
        calls.append(out[2].clone())
        return out

    MOE.route = recording
    try:
        with torch.no_grad():
            lg, cache = forward_prefill(params, cfg, toks, cache_window=64)
            served = []
            for _ in range(m):
                tok = torch.argmax(lg, -1).to(torch.int32)
                served.append(tok)
                lg, cache = forward_decode(params, cfg, tok, cache)
    finally:
        MOE.route = inner
    assert len(calls) == cfg.num_layers * (1 + m)
    assert [tuple(c.shape) for c in calls] == (
        [(B * S, 3)] * cfg.num_layers + [(B, 3)] * (cfg.num_layers * m))
    routes = [torch.cat([calls[i].view(B, S, 3)]
                        + [calls[cfg.num_layers * (1 + t) + i].view(B, 1, 3) for t in range(m - 1)],
                        1) for i in range(cfg.num_layers)]
    seq = torch.cat([toks] + [t[:, None].long() for t in served[:-1]], dim=1)
    plain = REF.logits(w, hf, [(seq, S)], 64)[0]
    routed, deficits = REF.logits(w, hf, [(seq, S)], 64, routes=[routes])
    assert torch.equal(routed[0], plain)
    assert deficits[0].shape == (cfg.num_layers, B, S + m - 1) and float(deficits[0].max()) == 0


@pytest.mark.parametrize("S,chunk,with_init", [(45, 32, False), (7, 32, True), (100, 64, False)])
def test_ssd_scan_pads_its_tail_exactly(S, chunk, with_init):
    g = torch.Generator().manual_seed(S)
    B, H, P, N = 2, 3, 16, 8
    x = torch.randn((B, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    A = -torch.rand((H,), generator=g) - 0.5
    Bm, Cm = torch.randn((B, S, N), generator=g), torch.randn((B, S, N), generator=g)
    init = torch.randn((B, H, P, N), generator=g) if with_init else None
    tracing.reset_counters("ssm.")
    y, state = ops.ssd_scan(x, dt, A, Bm, Cm, chunk, init)
    y_ref, state_ref = ref.ssd_scan_sequential_ref(x, dt, A, Bm, Cm, init)
    assert y.shape == x.shape
    assert float((y - y_ref).abs().max()) <= 1e-4 * max(float(y_ref.abs().max()), 1.0)
    assert float((state - state_ref).abs().max()) <= 1e-4 * max(float(state_ref.abs().max()), 1.0)
    assert tracing.counters().get("ssm.scan_pad_rows", 0) == B * (-S % chunk)


def test_ssd_scan_span_records_the_padding():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 40, 2, 16), generator=g)
    dt = torch.full((1, 40, 2), 0.1)
    tracing.enable()
    try:
        ops.ssd_scan(x, dt, -torch.ones(2), torch.randn((1, 40, 8), generator=g),
                     torch.randn((1, 40, 8), generator=g), 32)
    finally:
        tracing.disable()
    spans = [s for s in tracing.drain() if s.name == "ssm.scan"]
    assert [s.attrs for s in spans] == [{"batch": 1, "tokens": 40, "pad_rows": 24}]


def test_attention_takes_a_softmax_scale_on_the_plain_path():
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 9, 4, 64), generator=g)
    k, v = torch.randn((2, 9, 2, 64), generator=g), torch.randn((2, 9, 2, 64), generator=g)
    base = ops.flash_attention(q, k, v)
    assert torch.equal(base, ops.flash_attention(q, k, v, scale=64 ** -0.5))
    # scaling q by 8/64 at the default scale is the scale 1/64
    scaled = ops.flash_attention(q, k, v, scale=1 / 64)
    assert torch.allclose(scaled, ops.flash_attention(q * (8 / 64), k, v), atol=1e-6)
    assert not torch.allclose(scaled, base, atol=1e-3)
    pos = torch.full((2,), 8, dtype=torch.int32)
    kv_pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9).contiguous()
    valid = torch.ones((2, 9), dtype=torch.bool)
    step = ops.decode_attention(q[:, -1:], k, v, kv_pos, valid, pos, scale=1 / 64)
    assert torch.allclose(step, scaled[:, -1:], atol=1e-6)
    assert torch.equal(ops.decode_attention(q[:, -1:], k, v, kv_pos, valid, pos),
                       ops.decode_attention(q[:, -1:], k, v, kv_pos, valid, pos,
                                            scale=64 ** -0.5))


def test_published_config_counts_and_layout():
    cfg = get_config(ARCH)
    assert count_params_analytic(cfg) == 32_207_337_984
    assert cfg.family == "hybrid_moe" and ARCH.replace("-", "_").replace(".", "_") in PORT_ARCH_IDS
    assert [i for i, k in enumerate(cfg.layer_types) if k == "attention"] == [5, 15, 25, 35]
    assert (KV.num_attn_layers(cfg), KV.num_ssm_layers(cfg)) == (4, 36)
    assert KV.layer_slots(cfg)[:7] == (0, 1, 2, 3, 4, 0, 5) and KV.layer_slots(cfg)[35] == 3
    assert (cfg.d_inner, cfg.ssm_heads, KV.conv_dim(cfg)) == (8192, 128, 8448)
    assert cfg.attention_multiplier == 1 / 128 and not cfg.use_rope
    # the reduced variant: one layer of each kind, Mamba2 at expand 1 (8 heads of 32)
    small = get_reduced_config(ARCH)
    assert small.layer_types == ("mamba", "attention")
    assert (small.d_inner, small.ssm_heads) == (small.d_model, 8)


def test_serve_cli_reduced_cpu(monkeypatch, capsys):
    """``--arch granite-4.0-h-small --reduced --device cpu``: the launcher's
    loop on the CPU, no CUDA kernel touched; each request's tokens are the
    engine's own greedy tokens for that prompt alone."""
    def no_build(*args, **kwargs):
        raise AssertionError("a CPU run must not touch the CUDA build")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    ops.reset_launch_counts()
    served = serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                             "--max-new", "4", "--seed", "0"])
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHED, 0)
    out = capsys.readouterr().out
    assert "serving granite-4.0-h-small-reduced (reduced, hybrid_moe, bfloat16)" in out
    assert len(served) == 3 and all(len(r.result.tokens[0]) == 4 for r in served)


def test_decode_counts_the_state_bytes():
    cfg = get_reduced_config(ARCH)
    from repro_torch.models.model import init_params

    params = init_params(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        lg, cache = forward_prefill(params, cfg, torch.ones((2, 5), dtype=torch.int64),
                                    cache_window=16)
        tracing.reset_counters("ssm.")
        forward_decode(params, cfg, torch.argmax(lg, -1).to(torch.int32), cache)
    ssd, conv = cache["ssd"], cache["conv"]
    assert tracing.counters()["ssm.state_bytes"] == 2 * (ssd.numel() * 4 + conv.numel() * 2)


def test_engine_pads_to_the_longest_prompt_for_every_family():
    from repro_torch.serving.engine import ServingEngine

    for arch in ("granite-4.0-h-small", "mamba2-1.3b", "zamba2-7b", "qwen2.5-3b"):
        engine = ServingEngine(get_reduced_config(arch), {}, device="cpu")
        assert engine._pad_batch([[5] * 10, [7] * 70]).shape == (2, 70)


def test_dryrun_plans_the_published_model(tmp_path):
    """``launch/dryrun.py --arch granite-4.0-h-small``: the long_500k step
    on meta tensors; the tied head is planned once: 64.4 GB of bf16
    weights and the 4 attention layers' and 36 Mamba2 layers' cache."""
    from repro_torch.launch import dryrun

    (rec,) = dryrun.main(["--arch", ARCH, "--shape", "long_500k", "--out", str(tmp_path)])
    # 2 bytes a parameter, 4 for the float32 ones: the routers, A_log, dt_bias and D
    float32 = 40 * 4096 * 72 + 36 * 128 * 3
    assert rec["plan"]["params_bytes"] == 2 * count_params_analytic(get_config(ARCH)) + 2 * float32
    assert rec["plan"]["fits_card"] and rec["cost"]["flops"] > 0
    assert (tmp_path / "granite-4_0-h-small__long_500k__1x1.json").exists()
