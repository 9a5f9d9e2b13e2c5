"""The frozen work arithmetic, against hand-worked numbers and against the
program's dry run on the same step (where the two count the same work)."""

import json
from pathlib import Path

import pytest

from portbench import work

PB = Path(__file__).resolve().parents[1]
TINY = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512}


def test_pairs_and_keys_by_hand():
    assert work.prefill_pairs(4, None) == 10
    assert work.prefill_pairs(5, 2) == 1 + 2 + 2 + 2 + 2
    assert work.prefill_pairs(3, 8) == 6
    assert work.decode_keys(10, 1032) == 11
    assert work.decode_keys(5000, 4096) == 4097


def test_dense_prefill_by_hand():
    dm = work.dims(TINY)
    B, S = 2, 8
    tok = B * S
    proj = 2 * tok * 64 * (64 + 2 * 32) + 2 * tok * 64 * 64
    mlp = 2 * tok * 3 * 64 * 128
    attn = 4 * 4 * 16 * B * 36
    head = 2 * B * 64 * 512
    assert work.prefill_flops(dm, B, S) == 2 * (proj + mlp + attn) + head


def test_qwen_decode_step_by_hand():
    dm = work.dims(json.loads((PB / "configs" / "qwen2.5-3b.json").read_text()))
    per_layer = 2 * 2048 * (2048 + 512) + 2 * 2048 * 2048 + 6 * 2048 * 11008 + 4 * 2048 * 101
    assert work.decode_flops(dm, 1, 100, 1032) == 36 * per_layer + 2 * 2048 * 151936


def test_moe_counts_top_k_without_capacity_padding():
    dm = work.dims(dict(TINY, num_local_experts=4, num_experts_per_tok=2))
    c = work.moe_calls(dm, 10)
    assert c["ops"] == 3 * 2 * 20 * 64 * 128
    assert 0 < work.live_experts(dm, 1) == pytest.approx(2.0)
    assert work.live_experts(dm, 1000) == pytest.approx(4.0)


def test_against_the_dry_run_on_the_same_prefill():
    """The dry run counts the program's prefill step on meta tensors: the
    same projections, MLP and attention pairs, and the head at every
    position, where the benchmark counts it at the last one only."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import step_cost

    from portbench import harness

    cfg = dict(TINY, name="tiny", source="test", attention_bias=True, rope_theta=1e6,
               rms_norm_eps=1e-5, torch_dtype="bfloat16",
               port={"family": "dense", "mlp_type": "swiglu"})
    B, S = 2, 16
    dry = step_cost(harness.port_config(cfg), ShapeConfig("t", S, B, "prefill"))["flops"]
    ours = work.prefill_flops(work.dims(cfg), B, S)
    assert dry - ours == 2 * B * (S - 1) * 64 * 512
