"""The plain references against the program on the CPU at test size: the
decoder reference's float32 logits against the port's float32 prefill and
decode steps (dense, and experts with capacity drops, a sliding window
and a ring shorter than the prompt; for experts also routed as the
program routed, every choice then the reference's own), and the NumPy
allocator against the port's allocator, allocation by allocation."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.references import decoder, shabari_allocator

from cpu_cells import TINY


def _tree(t, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in t.items()}


def _case(name, lens, max_new, seed, routed=False, **over):
    """The port's float32 logits at each generated position and the
    reference's; ``routed``: the reference takes the port's routing, as
    the engine's call records it (a last step whose token is not read
    included), and the deficits come back third."""
    from repro_torch.models.model import forward_decode, forward_prefill

    cfg = dict(TINY[name], name=name, source="test", **over)
    w = decoder.make_weights(cfg, seed, "cpu")
    port = harness.port_config(dict(cfg, torch_dtype="float32"))
    params = _tree(w, lambda x: x.float())
    rng = np.random.default_rng(seed)
    S = max(lens)
    W = min(S + max_new, cfg["sliding_window"]) if cfg["sliding_window"] else S + max_new
    prompts = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        prompts[i, S - n:] = rng.integers(1, cfg["vocab_size"], n)
    teach = torch.from_numpy(rng.integers(1, cfg["vocab_size"], (len(lens), max_new)))
    got = []
    with torch.no_grad(), harness.recorded_routes() as calls:
        lg, cache = forward_prefill(params, port, torch.from_numpy(prompts), cache_window=W)
        got.append(lg)
        for j in range(max_new):
            lg, cache = forward_decode(params, port, teach[:, j].to(torch.int32), cache)
            got.append(lg)
    got = torch.stack(got[:max_new], 1)
    seq = torch.cat([torch.from_numpy(prompts), teach[:, :max_new - 1]], dim=1)
    if not routed:
        return got, decoder.logits(w, cfg, [(seq, S)], W)[0]
    rec = SimpleNamespace(batch=len(lens), padded_len=S, max_new=max_new)
    routes = check.routes(calls, cfg["num_hidden_layers"], cfg["num_experts_per_tok"], rec)
    want, deficits = decoder.logits(w, cfg, [(seq, S)], W, routes=[routes])
    return got, want[0], deficits[0]


@pytest.mark.parametrize("name,lens,max_new,over", [
    ("tiny-dense", (9, 30, 17), 4, {}),
    ("tiny-dense", (5,), 1, {}),
    ("tiny-dense", (9, 30, 17), 4, {"tie_word_embeddings": True, "rms_norm_eps": 1e-06}),
    ("tiny-moe", (40, 10, 7), 4, {}),  # pads overflow an expert; window 24 < prompt
    ("tiny-moe", (12, 3), 3, {}),
])
def test_reference_matches_the_port_in_float32(one_thread, name, lens, max_new, over):
    got, want = _case(name, lens, max_new, seed=7, **over)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 2e-5 * scale


@pytest.mark.parametrize("lens,max_new", [
    ((40, 10, 7), 4),  # pads overflow an expert; window 24 < prompt
    ((12, 3), 3),
])
def test_routed_reference_matches_the_port_in_float32(one_thread, lens, max_new):
    got, want, deficits = _case("tiny-moe", lens, max_new, seed=7, routed=True)
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    L, S = TINY["tiny-moe"]["num_hidden_layers"], max(lens)
    assert deficits.shape == (L, len(lens), S + max_new - 1)
    assert deficits.abs().max() == 0


def test_given_routes_are_taken_and_their_deficit_read(one_thread):
    """The reference takes the experts it is given: two disjoint pairs give
    different logits, and at each (token, layer) at most one of them is
    its own top-2, so the other's deficit is above 0."""
    cfg = dict(TINY["tiny-moe"], name="tiny-moe", source="test")
    w = decoder.make_weights(cfg, 3, "cpu")
    L = cfg["num_hidden_layers"]
    S, m = 9, 3
    seq = torch.from_numpy(np.random.default_rng(3).integers(1, cfg["vocab_size"], (2, S + m - 1)))

    def given(pair):
        return [torch.tensor(pair).expand(2, S + m - 1, 2) for _ in range(L)]

    lo, d_lo = decoder.logits(w, cfg, [(seq, S)], 64, routes=[given((0, 1))])
    hi, d_hi = decoder.logits(w, cfg, [(seq, S)], 64, routes=[given((2, 3))])
    assert not torch.allclose(lo[0], hi[0])
    assert (d_lo[0] >= 0).all() and (d_hi[0] >= 0).all()
    assert ((d_lo[0] > 0) | (d_hi[0] > 0)).all()


def test_allocator_reference_matches_the_port(one_thread):
    from repro_torch.core import Featurizer, Observation, ResourceAllocator

    rng = np.random.default_rng(3)
    feat, alloc = Featurizer(), ResourceAllocator(vcpu_confidence=2, mem_confidence=4,
                                                  device="cpu")
    invs, served = [], []
    for _ in range(80):
        b = int(rng.choice([1, 2, 4, 8]))
        lens = rng.integers(64, 1025, b)
        inv = {"padded_len": int(lens.max()), "batch": b, "max_new": int(rng.choice([1, 2, 4, 8])),
               "prompt_tokens": int(lens.sum()), "exec_s": float(rng.uniform(0.05, 3.0)),
               "slo_s": float(rng.uniform(0.1, 2.0))}
        x = feat.extract("f", "request", {"prompt_tokens": inv["padded_len"], "batch": b,
                                          "max_new_tokens": inv["max_new"], "image_tiles": 0,
                                          "audio_seconds": 0})
        a = alloc.allocate("f", x)
        used_v, used_mb = shabari_allocator.usage(inv["prompt_tokens"], a.vcpus)
        alloc.feedback("f", x, Observation(
            exec_time_s=inv["exec_s"], slo_s=inv["slo_s"], alloc_vcpus=a.vcpus,
            max_vcpus_used=used_v, alloc_mem_mb=a.mem_mb, max_mem_used_mb=used_mb))
        invs.append(inv)
        served.append((a.vcpus, a.mem_mb))
    ref = shabari_allocator.replay(invs, vcpu_classes=32, mem_classes=40, vcpu_confidence=2,
                                   mem_confidence=4, default_vcpus=10, default_mem_class=32,
                                   class_mb=128)
    assert served == ref
    assert len(set(served)) > 3  # the agents moved off the defaults


def test_tied_head_is_a_view_of_the_embedding():
    cfg = dict(TINY["tiny-dense"], name="t", source="test", tie_word_embeddings=True)
    w = decoder.make_weights(cfg, 3, "cpu")
    assert w["lm_head"].shape == (cfg["hidden_size"], cfg["vocab_size"])
    assert w["lm_head"].data_ptr() == w["embed"].data_ptr()
    untied = decoder.make_weights(TINY["tiny-dense"], 3, "cpu")
    assert torch.equal(untied["embed"], w["embed"])
    assert not torch.equal(untied["lm_head"], w["lm_head"])
