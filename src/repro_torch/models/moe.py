"""Mixture-of-Experts block: top-k router + capacity-based scatter dispatch
(port of ``repro/models/moe.py``).

Each (token, choice) gets its expert and a slot from a cumulative count,
ranked choice-major so that every top-1 choice is placed before any
top-2 choice and is never dropped first. Tokens are scattered into
per-expert buffers (E, C, D); the experts' gate, up and down products run
as three grouped matmuls through :func:`repro_torch.kernels.ops.moe_gmm`
(the hand-written CUDA kernel on the card) when ``use_kernels`` is set,
else through the plain :func:`repro_torch.kernels.ref.moe_gmm_ref`; the
results gather back weighted by the router gates. Switch/GShard capacity
semantics with capacity factor 1.25. Arctic also runs a dense SwiGLU
path in parallel (``models/model.py``).

The dispatch is the reference's step for step, in its dtypes. Two
details of JAX are written out here: an assignment that does not fit
writes to a sacrificial slot C of an (E, C+1, D) buffer (cut away before
the experts run), and reading slot C back from the (E, C, D) expert
output is clamped to C - 1, as a JAX gather clamps an index that is out
of range; either way its gate is 0.

The reference's ``set_moe_seq_chunks(n)`` is
:func:`moe_block_seq_chunked`: the flattened tokens dispatched in ``n``
equal chunks, one after the other, each with its own capacity, and the
block's aux loss the mean of the chunks'. That divides the (E, C, D)
buffers by ``n`` and changes which assignments fit, as it does in the
reference. It is a function, not a switch: no path of the port takes it
yet (the reference uses it to bound the expert buffers' peak memory at
prefill_32k / train_4k scale, for arctic-480b on a production mesh).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]

CAPACITY_FACTOR = 1.25


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead=(), device=None) -> Params:
    """Random parameters with the reference's keys, shapes, scales and
    types: a float32 router (D, E); expert weights ``wg``/``wu`` (E, D, F)
    scaled by D**-0.5 and ``wd`` (E, F, D) by F**-0.5 in the model dtype.
    ``lead`` stacks layers on leading axes."""
    dt = cfg.torch_dtype
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "router": dense_init(gen, D, E, torch.float32, lead=lead, device=device),
        "wg": dense_init(gen, D, Fd, dt, lead=lead + (E,), device=device),
        "wu": dense_init(gen, D, Fd, dt, lead=lead + (E,), device=device),
        "wd": dense_init(gen, Fd, D, dt, lead=lead + (E,), device=device),
    }


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(CAPACITY_FACTOR * num_tokens * cfg.experts_per_token / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to multiple of 8


def route(p: Params, cfg: ModelConfig, xt: torch.Tensor):
    """The router over tokens xt (T, D): softmax in float32 over the float32
    logits, the top ``experts_per_token`` experts, their gates renormalised.
    Returns (probs (T, E), gates (T, K), expert_ids (T, K))."""
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_ids


def dispatch(expert_ids: torch.Tensor, num_experts: int, capacity: int):
    """Slots for the (token, choice) assignments, ranked choice-major: the
    K*T assignments are taken choice by choice (all top-1 choices, then
    all top-2 choices), and each gets its rank among earlier assignments
    to the same expert. Returns (flat_expert, slot, keep), each (K*T,) in
    that order; ``keep`` is ``slot < capacity``."""
    flat_expert = expert_ids.T.reshape(-1)
    onehot = F.one_hot(flat_expert, num_experts)
    ranks = torch.cumsum(onehot, dim=0) - onehot  # rank among same-expert assigns
    slot = torch.sum(ranks * onehot, dim=-1)
    return flat_expert, slot, slot < capacity


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None, *,
              use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D). Returns (out (B, S, D), Switch aux loss, a float32 scalar)."""
    Bsz, S, D = x.shape
    y, aux = _moe_tokens(p, cfg, x.reshape(Bsz * S, D), capacity, use_kernels)
    return y.reshape(Bsz, S, D), aux


def moe_block_seq_chunked(p: Params, cfg: ModelConfig, x: torch.Tensor, chunks: int,
                          capacity: Optional[int] = None, *,
                          use_kernels: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_block` with the B*S tokens dispatched in ``chunks`` equal
    chunks, each at its own capacity; the aux loss is the chunks' mean (the
    reference's ``moe_block`` under ``set_moe_seq_chunks(chunks)``). A
    token count that ``chunks`` does not divide, or chunks under 8 tokens,
    run unchunked, as there."""
    Bsz, S, D = x.shape
    T = Bsz * S
    if chunks <= 1 or T % chunks or T // chunks < 8:
        return moe_block(p, cfg, x, capacity, use_kernels=use_kernels)
    outs = [_moe_tokens(p, cfg, xc, capacity, use_kernels)
            for xc in x.reshape(chunks, T // chunks, D)]
    y = torch.cat([o for o, _ in outs])
    return y.reshape(Bsz, S, D), torch.stack([a for _, a in outs]).mean()


def _moe_tokens(p: Params, cfg: ModelConfig, xt: torch.Tensor,
                capacity: Optional[int], use_kernels: bool):
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity if capacity is not None else moe_capacity(cfg, T)
    gmm = ops.moe_gmm if use_kernels else ref.moe_gmm_ref
    probs, gate_vals, expert_ids = route(p, cfg, xt)
    flat_expert, slot, keep = dispatch(expert_ids, E, C)

    # --- scatter tokens into expert buffers: kept slots are unique, so a
    # plain write is the reference's add into zeros; dropped assignments
    # (zeroed) go to the sacrificial slot C ------------------------------
    token_ids = torch.arange(T, device=xt.device).repeat(K)
    src = xt[token_ids] * keep[:, None].to(xt.dtype)
    write_slot = torch.where(keep, slot, C)
    buf = torch.zeros((E, C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[flat_expert, write_slot] = src
    buf = buf[:, :C]  # a strided view: the kernel takes its strides

    # --- expert compute: three grouped matmuls --------------------------
    h = F.silu(gmm(buf, p["wg"])) * gmm(buf, p["wu"])
    out_buf = gmm(h, p["wd"])

    # --- gather back, weighted by gates (slot C reads as C - 1, gate 0) --
    out_flat = out_buf[flat_expert, write_slot.clamp(max=C - 1)]
    gates_flat = gate_vals.T.reshape(-1)
    out_flat = out_flat * (gates_flat * keep).to(out_flat.dtype)[:, None]
    y = torch.zeros((T, D), dtype=out_flat.dtype, device=xt.device)
    y.index_add_(0, token_ids, out_flat)  # K terms per token into zeros: any order

    # --- load-balance aux loss (Switch): E * sum_e f_e * P_e ------------
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return y, aux


def moe_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
               use_kernels: bool = True) -> torch.Tensor:
    """Decode-time MoE on x (B, D): the same dispatch with a one-token
    sequence. The expert buffers hold a few tokens (capacity 8 at batch
    1), so each expert product reads every expert's weights for them:
    weight-bandwidth-bound."""
    y, _ = moe_block(p, cfg, x[:, None, :], use_kernels=use_kernels)
    return y[:, 0, :]


def moe_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    E = cfg.experts_per_token if active_only else cfg.num_experts
    n = cfg.d_model * cfg.num_experts  # router
    n += E * 3 * cfg.d_model * cfg.d_ff
    return n
