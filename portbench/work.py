"""The benchmark's frozen work arithmetic and table of peaks.

Operations and bytes of a forward pass and of each kernel call of a
decoder (dense or with sparse experts), counted from the configuration
file and the traffic alone, never from the program's launch shapes, so a
count stays the same whatever implements it. Conventions:

* a multiply-add is 2 operations; weights and activations are bfloat16
  (2 bytes), the router float32;
* attention counts the (query, key) pairs the semantics keeps: causal,
  within the sliding window at prefill; a decode step at position p
  attends the ring's min(p, W) entries and itself (W the cache window);
* every position of a padded prompt counts: pads are attended;
* the output head counts only where its logits are used: the last
  prompt position, and decode steps whose token is served (the engine's
  last decode step computes logits nobody reads: none of its work is
  useful);
* experts count at top-k, without the capacity padding;
* a kernel's bytes: each input read once and each output written once;
  for the expert products, the weights of the experts that hold a token,
  in expectation over uniform routing where the data decides it.

Peaks: one NVIDIA H100 SXM at its 700 W limit, dense bf16 989 TFLOP/s,
HBM 3.35 TB/s (NVIDIA's data sheet).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    experts: int  # 0: dense MLP
    top_k: int
    window: Optional[int]  # sliding window at prefill, None: full

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def dims(cfg: Dict) -> Dims:
    """The sizes that the arithmetic needs, from a configuration file."""
    heads = cfg["num_attention_heads"]
    return Dims(
        layers=cfg["num_hidden_layers"], d=cfg["hidden_size"], heads=heads,
        kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // heads,
        ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        window=cfg.get("sliding_window"))


def prefill_pairs(S: int, window: Optional[int]) -> int:
    """Live (query, key) pairs of one causal row of S positions."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def decode_keys(pos: int, cache_window: int) -> int:
    """Keys a decode step at position ``pos`` attends: the ring's live
    entries and the token itself."""
    return min(pos, cache_window) + 1


def live_experts(dm: Dims, assignments_tokens: int) -> float:
    """Expected experts that hold at least one of ``assignments_tokens``
    tokens' top-k choices, each token's k distinct experts uniform."""
    if not dm.experts:
        return 0.0
    miss = math.comb(dm.experts - 1, dm.top_k) / math.comb(dm.experts, dm.top_k)
    return dm.experts * (1.0 - miss ** assignments_tokens)


def _layer_dense_flops(dm: Dims, tokens: int) -> float:
    """Projections and the MLP or experts of one layer over ``tokens``."""
    proj = 2 * tokens * dm.d * (dm.q_dim + 2 * dm.kv_dim) + 2 * tokens * dm.q_dim * dm.d
    if dm.experts:
        mlp = 2 * tokens * dm.d * dm.experts + 2 * tokens * dm.top_k * 3 * dm.d * dm.ff
    else:
        mlp = 2 * tokens * 3 * dm.d * dm.ff
    return float(proj + mlp)


def attention_flops(dm: Dims, pairs: int) -> float:
    """QK^T and PV over ``pairs`` live pairs, every query head."""
    return 4.0 * dm.heads * dm.head_dim * pairs


def prefill_flops(dm: Dims, batch: int, S: int) -> float:
    """A prefill of ``batch`` rows padded to S; the head at the last position."""
    per_layer = _layer_dense_flops(dm, batch * S) + attention_flops(
        dm, batch * prefill_pairs(S, dm.window))
    return dm.layers * per_layer + 2.0 * batch * dm.d * dm.vocab


def decode_flops(dm: Dims, batch: int, pos: int, cache_window: int) -> float:
    """One decode step of ``batch`` rows at position ``pos``, its head included."""
    per_layer = _layer_dense_flops(dm, batch) + attention_flops(
        dm, batch * decode_keys(pos, cache_window))
    return dm.layers * per_layer + 2.0 * batch * dm.d * dm.vocab


def invocation_flops(dm: Dims, batch: int, S: int, max_new: int, cache_window: int) -> float:
    """Useful operations of one invocation: the prefill, and the decode
    steps whose tokens are served (tokens 2..max_new)."""
    return prefill_flops(dm, batch, S) + sum(
        decode_flops(dm, batch, S + j, cache_window) for j in range(max_new - 1))


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def flash_call(dm: Dims, batch: int, S: int) -> Dict[str, float]:
    """One prefill attention call (one layer): q, k, v in, o out."""
    ops = attention_flops(dm, batch * prefill_pairs(S, dm.window))
    nbytes = BF16 * batch * S * (2 * dm.q_dim + 2 * dm.kv_dim)
    return {"ops": ops, "bytes": float(nbytes)}


def decode_call(dm: Dims, batch: int, pos: int, cache_window: int) -> Dict[str, float]:
    """One decode attention call (one layer): q and the live K/V in, o out."""
    keys = decode_keys(pos, cache_window)
    ops = attention_flops(dm, batch * keys)
    nbytes = BF16 * batch * (2 * dm.q_dim + 2 * keys * dm.kv_dim)
    return {"ops": ops, "bytes": float(nbytes)}


def moe_calls(dm: Dims, tokens: int) -> Dict[str, float]:
    """The three expert products (gate, up, down) of one layer over
    ``tokens`` tokens, summed."""
    routed = tokens * dm.top_k
    ops = 3 * 2.0 * routed * dm.d * dm.ff
    weights = live_experts(dm, tokens) * 3 * dm.d * dm.ff * BF16
    acts = BF16 * routed * 3 * (dm.d + dm.ff)  # gate, up: D in, F out; down: F in, D out
    return {"ops": ops, "bytes": weights + acts}
