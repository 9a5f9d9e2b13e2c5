"""The work arithmetic of a hybrid of Mamba2 and attention layers with
sparse and shared experts (Granite 4.0-H, ``granitemoehybrid``).

Counted from the configuration file and the traffic alone, never from the
program's launch shapes, with ``work.py``'s conventions and peaks: a
multiply-add is 2 operations; weights and activations bfloat16, the
router, dt and the SSD state float32; every position of a padded prompt
counts; attention counts the live (query, key) pairs on the attention
layers alone; experts at top-k without padding, the shared expert on
every token; the head only where its logits are read (the last prompt
position, and the decode steps whose token is served).

The SSD scan of a prefill counts its chunked dual form at the
configuration's ``mamba_chunk_size`` Q over the B x S positions (the
last chunk of a row holds S mod Q of them where Q does not divide S):
within a chunk of q positions, C.B^T over its q(q+1)/2 causal pairs (N
wide, shared by the heads: n_groups 1) and the decayed scores times
dt x (every head, P wide); the chunk's state, B^T (dt x) decayed to its
end, and the state's part of the outputs, C.state (each q x N x H x P).
Its bytes: x, dt, B and C read once, y and the final state written once.
A decode step's recurrence counts the state's update, dt x B^T
accumulated into the decayed state, and C.state: two multiply-adds per
state element.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from portbench import work

BF16, F32 = 2, 4


@dataclasses.dataclass(frozen=True)
class Hybrid:
    base: work.Dims  # widths of the attention layers, the experts and the head
    attention_layers: int
    mamba_layers: int
    heads: int  # Mamba2 heads
    head_dim: int  # P
    state: int  # N
    conv: int  # conv width
    chunk: int  # Q
    shared_ff: int

    @property
    def d_inner(self) -> int:
        return self.heads * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.state

    @property
    def proj(self) -> int:
        return 2 * self.d_inner + 2 * self.state + self.heads


def dims(cfg: Dict) -> Hybrid:
    kinds = cfg["layer_types"]
    return Hybrid(base=work.dims(cfg), attention_layers=kinds.count("attention"),
                  mamba_layers=kinds.count("mamba"), heads=cfg["mamba_n_heads"],
                  head_dim=cfg["mamba_d_head"], state=cfg["mamba_d_state"],
                  conv=cfg["mamba_d_conv"], chunk=cfg["mamba_chunk_size"],
                  shared_ff=cfg["shared_intermediate_size"])


def ssd_call(hm: Hybrid, batch: int, S: int) -> Dict[str, float]:
    """One prefill's SSD scan in one Mamba2 layer over ``batch`` rows of S."""
    H, P, N, Q = hm.heads, hm.head_dim, hm.state, hm.chunk
    full, rest = divmod(S, Q)
    pairs = full * Q * (Q + 1) // 2 + rest * (rest + 1) // 2
    ops = batch * (2.0 * pairs * (N + H * P) + 2 * 2.0 * S * N * H * P)
    nbytes = batch * (S * (2 * H * P * BF16 + H * F32 + 2 * N * BF16) + H * P * N * F32)
    return {"ops": ops, "bytes": float(nbytes)}


def _mamba_dense_flops(hm: Hybrid, tokens: int) -> float:
    """in_proj, the conv and out_proj of one Mamba2 layer over ``tokens``."""
    d = hm.base.d
    return 2.0 * tokens * (d * hm.proj + hm.conv * hm.conv_dim + hm.d_inner * d)


def _attention_dense_flops(hm: Hybrid, tokens: int) -> float:
    dm = hm.base
    return 2.0 * tokens * (dm.d * (dm.q_dim + 2 * dm.kv_dim) + dm.q_dim * dm.d)


def _ffn_flops(hm: Hybrid, tokens: int) -> float:
    """The router, the top-k experts and the shared expert over ``tokens``."""
    dm = hm.base
    return 2.0 * tokens * (dm.d * dm.experts + dm.top_k * 3 * dm.d * dm.ff
                           + 3 * dm.d * hm.shared_ff)


def prefill_flops(hm: Hybrid, batch: int, S: int) -> float:
    """A prefill of ``batch`` rows padded to S; the head at the last position."""
    dm, T = hm.base, batch * S
    mamba = _mamba_dense_flops(hm, T) + ssd_call(hm, batch, S)["ops"]
    attn = _attention_dense_flops(hm, T) + work.attention_flops(
        dm, batch * work.prefill_pairs(S, dm.window))
    return (hm.mamba_layers * mamba + hm.attention_layers * attn
            + dm.layers * _ffn_flops(hm, T) + 2.0 * batch * dm.d * dm.vocab)


def decode_flops(hm: Hybrid, batch: int, pos: int, cache_window: int) -> float:
    """One decode step of ``batch`` rows at position ``pos``, its head included."""
    dm = hm.base
    mamba = _mamba_dense_flops(hm, batch) + batch * 4.0 * hm.d_inner * hm.state
    attn = _attention_dense_flops(hm, batch) + work.attention_flops(
        dm, batch * work.decode_keys(pos, cache_window))
    return (hm.mamba_layers * mamba + hm.attention_layers * attn
            + dm.layers * _ffn_flops(hm, batch) + 2.0 * batch * dm.d * dm.vocab)


def invocation_flops(hm: Hybrid, batch: int, S: int, max_new: int, cache_window: int) -> float:
    """Useful operations of one invocation: the prefill, and the decode
    steps whose tokens are served (tokens 2..max_new)."""
    return prefill_flops(hm, batch, S) + sum(
        decode_flops(hm, batch, S + j, cache_window) for j in range(max_new - 1))
