"""Mixture-of-Experts block: the top-k router, then one of two dispatches
(port of ``repro/models/moe.py``, whose dispatch is the first).

Capacity (``cfg.moe_capacity_factor`` a number, the reference's 1.25 by
default): each (token, choice) gets its expert and a slot from a
cumulative count, ranked choice-major so that every top-1 choice is
placed before any top-2 choice and is never dropped first. Tokens are
scattered into per-expert buffers (E, C, D); the experts' gate, up and
down products run as three grouped matmuls through
:func:`repro_torch.kernels.ops.moe_gmm`, handed ``use_kernels`` (the
hand-written CUDA kernel on the card while it is set, else the plain
:func:`repro_torch.kernels.ref.moe_gmm_ref`); the results gather back
weighted by the router gates. Switch/GShard capacity semantics. Arctic
also runs a dense SwiGLU path in parallel (``models/model.py``).

The capacity dispatch is the reference's step for step, in its dtypes.
Two details of JAX are written out here: an assignment that does not fit
writes to a sacrificial slot C of an (E, C+1, D) buffer (cut away before
the experts run), and reading slot C back from the (E, C, D) expert
output is clamped to C - 1, as a JAX gather clamps an index that is out
of range; either way its gate is 0.

Dropless (``moe_capacity_factor`` None; Mixtral's published block sends
every token to its top-k experts): the T*k assignments are sorted by
expert, then by token (a stable sort of the token-major expert ids), the
E+1 group offsets are a cumulative sum of a ``scatter_add`` count, and
the sorted rows (T*k, D) go through three ragged grouped matmuls
(:func:`repro_torch.kernels.ops.moe_gmm_grouped`: expert e takes rows
``offsets[e]:offsets[e+1]``); each token's k rows come back weighted by
its float32 gates, summed in float32. At most ``PADDED_DROPLESS_TOKENS``
tokens (a decode step) take the capacity layout at C = that many slots
instead: a token gives an expert at most one row, so no assignment can
fall past the capacity, and ``ops.moe_gmm``'s decode body reads only the
experts that hold a row; the rows come back summed as the sorted layout
sums them. Every shape depends on T alone and nothing is read back on
the host, so a decode step with this dispatch records into a CUDA graph
like any other.

The reference's ``set_moe_seq_chunks(n)`` is
:func:`moe_block_seq_chunked`: the flattened tokens dispatched in ``n``
equal chunks, one after the other, each with its own capacity, and the
block's aux loss the mean of the chunks'. That divides the (E, C, D)
buffers by ``n`` and changes which assignments fit, as it does in the
reference. It is a function, not a switch: no path of the port takes it
yet (the reference uses it to bound the expert buffers' peak memory at
prefill_32k / train_4k scale, for arctic-480b on a production mesh).

A shared expert (``cfg.shared_d_ff``, Granite 4.0-H): one SwiGLU MLP of
that width, ``p["shared"]``, runs on every token beside the routed
experts, and its output is added to theirs. It never goes through the
router.

The Switch load-balance aux loss is computed only where the caller asks
(``aux=True``: training, :func:`repro_torch.models.model.forward_train`);
serving, and so the decode graph, never computes it.

Tracing (:mod:`repro_torch.tracing`): the span ``moe.dispatch`` (tokens,
rows, experts, dropless) over the router, the sort or slotting and the
gather of a call; inside a CUDA graph's recording it records once, at
the capture, and never on a replay. The counter ``moe.routed_rows``
adds the call's T*k assignments (known on the host; a graph's replay
adds its recorded counts again, ``serving/engine.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, init_mlp, mlp

Params = Dict[str, Any]

# the most tokens the dropless dispatch sends through the (E, C, D) capacity
# layout (at C = this many slots) rather than through rows sorted by expert
PADDED_DROPLESS_TOKENS = 8


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, lead=(), device=None) -> Params:
    """Random parameters with the reference's keys, shapes, scales and
    types: a float32 router (D, E); expert weights ``wg``/``wu`` (E, D, F)
    scaled by D**-0.5 and ``wd`` (E, F, D) by F**-0.5 in the model dtype;
    with ``cfg.shared_d_ff``, the shared expert's MLP under ``shared``.
    ``lead`` stacks layers on leading axes."""
    dt = cfg.torch_dtype
    E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, D, E, torch.float32, lead=lead, device=device),
        "wg": dense_init(gen, D, Fd, dt, lead=lead + (E,), device=device),
        "wu": dense_init(gen, D, Fd, dt, lead=lead + (E,), device=device),
        "wd": dense_init(gen, Fd, D, dt, lead=lead + (E,), device=device),
    }
    if cfg.shared_d_ff:
        p["shared"] = init_mlp(gen, cfg, lead=lead, device=device, d_ff=cfg.shared_d_ff)
    return p


def moe_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots an expert keeps for ``num_tokens`` tokens in the capacity
    dispatch (a config with a ``moe_capacity_factor``)."""
    cap = int(cfg.moe_capacity_factor * num_tokens * cfg.experts_per_token / cfg.num_experts)
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


def sort_by_expert(expert_ids: torch.Tensor, num_experts: int):
    """The dropless dispatch's order: the T*k assignments, token-major
    (assignment t*k + j is token t's j-th choice), sorted by expert and,
    within an expert, by token. Returns (order (T*k,), the index of the
    assignment each sorted row holds; offsets (E+1,) int32, expert e's
    rows ``offsets[e]:offsets[e+1]``). Counted on the device into a tensor
    of fixed size: nothing is read back."""
    flat = expert_ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(num_experts, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None, *, use_kernels: bool = True,
              aux: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D). Returns (out (B, S, D), the Switch aux loss as a float32
    scalar where ``aux`` is asked, else None). A ``capacity`` given takes
    the capacity dispatch at that capacity whatever the config says."""
    Bsz, S, D = x.shape
    y, loss = _moe_tokens(p, cfg, x.reshape(Bsz * S, D), capacity, use_kernels, aux)
    return y.reshape(Bsz, S, D), loss


def moe_block_seq_chunked(p: Params, cfg: ModelConfig, x: torch.Tensor, chunks: int,
                          capacity: Optional[int] = None, *, use_kernels: bool = True,
                          aux: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`moe_block` with the B*S tokens dispatched in ``chunks`` equal
    chunks, each at its own capacity; the aux loss is the chunks' mean (the
    reference's ``moe_block`` under ``set_moe_seq_chunks(chunks)``). A
    token count that ``chunks`` does not divide, or chunks under 8 tokens,
    run unchunked, as there."""
    Bsz, S, D = x.shape
    T = Bsz * S
    if chunks <= 1 or T % chunks or T // chunks < 8:
        return moe_block(p, cfg, x, capacity, use_kernels=use_kernels, aux=aux)
    outs = [_moe_tokens(p, cfg, xc, capacity, use_kernels, aux)
            for xc in x.reshape(chunks, T // chunks, D)]
    y = torch.cat([o for o, _ in outs])
    loss = torch.stack([a for _, a in outs]).mean() if aux else None
    return y.reshape(Bsz, S, D), loss


def _moe_tokens(p: Params, cfg: ModelConfig, xt: torch.Tensor,
                capacity: Optional[int], use_kernels: bool, aux: bool):
    T, D = xt.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dropless = capacity is None and cfg.moe_capacity_factor is None
    sort = dropless and T > PADDED_DROPLESS_TOKENS
    tracing.count("moe.routed_rows", T * K)
    with tracing.span("moe.dispatch", tokens=T, rows=T * K, experts=E, dropless=dropless):
        probs, gate_vals, expert_ids = route(p, cfg, xt)
        if sort:
            order, offsets = sort_by_expert(expert_ids, E)
            rows = xt[order // K]
        else:
            if capacity is not None:
                C = capacity
            else:
                C = PADDED_DROPLESS_TOKENS if dropless else moe_capacity(cfg, T)
            flat_expert, slot, keep = dispatch(expert_ids, E, C)
            # scatter tokens into expert buffers: kept slots are unique, so a
            # plain write is the reference's add into zeros; dropped
            # assignments (zeroed) go to the sacrificial slot C
            token_ids = torch.arange(T, device=xt.device).repeat(K)
            src = xt[token_ids] * keep[:, None].to(xt.dtype)
            write_slot = torch.where(keep, slot, C)
            buf = torch.zeros((E, C + 1, D), dtype=xt.dtype, device=xt.device)
            buf[flat_expert, write_slot] = src
            buf = buf[:, :C]  # a strided view: the kernel takes its strides
    if sort:
        y = _experts_dropless(p, rows, order, offsets, gate_vals, use_kernels)
    else:
        y = _experts_capacity(p, buf, flat_expert, write_slot, keep, token_ids, gate_vals, T,
                              use_kernels, dropless)
    if "shared" in p:
        y = y + mlp(p["shared"], cfg, xt)
    loss = None
    if aux:  # load-balance aux loss (Switch): E * sum_e f_e * P_e
        me = probs.mean(dim=0)
        ce = F.one_hot(expert_ids[:, 0], E).float().mean(dim=0)
        loss = E * torch.sum(me * ce)
    return y, loss


def _experts_capacity(p: Params, buf, flat_expert, write_slot, keep, token_ids, gate_vals,
                      T: int, use_kernels: bool, dropless: bool) -> torch.Tensor:
    """The three grouped matmuls over the (E, C, D) buffers, gathered back
    weighted by the gates (slot C reads as C - 1, gate 0). ``dropless``
    (every assignment kept): a token's k rows summed in float32 with its
    float32 gates, as :func:`_experts_dropless` sums them."""
    gmm = functools.partial(ops.moe_gmm, use_kernels=use_kernels)
    C = buf.shape[1]
    h = F.silu(gmm(buf, p["wg"])) * gmm(buf, p["wu"])
    out_buf = gmm(h, p["wd"])
    out_flat = out_buf[flat_expert, write_slot.clamp(max=C - 1)]
    if dropless:  # choice-major rows: (k, T, D)
        y = (out_flat.view(gate_vals.shape[1], T, -1).float() * gate_vals.T[..., None]).sum(0)
        return y.to(buf.dtype)
    gates_flat = gate_vals.T.reshape(-1)
    out_flat = out_flat * (gates_flat * keep).to(out_flat.dtype)[:, None]
    y = torch.zeros((T, buf.shape[2]), dtype=out_flat.dtype, device=buf.device)
    y.index_add_(0, token_ids, out_flat)  # K terms per token into zeros: any order
    return y


def _experts_dropless(p: Params, rows: torch.Tensor, order: torch.Tensor,
                      offsets: torch.Tensor, gate_vals: torch.Tensor,
                      use_kernels: bool) -> torch.Tensor:
    """The three ragged grouped matmuls over the expert-sorted rows; each
    row put back at its assignment (unique indices: a plain copy), and a
    token's k rows summed in float32, weighted by its float32 gates."""
    gmm = functools.partial(ops.moe_gmm_grouped, use_kernels=use_kernels)
    h = F.silu(gmm(rows, p["wg"], offsets)) * gmm(rows, p["wu"], offsets)
    out_sorted = gmm(h, p["wd"], offsets)
    out = torch.empty_like(out_sorted).index_copy_(0, order, out_sorted)
    T, K = gate_vals.shape
    y = (out.view(T, K, -1).float() * gate_vals[..., None]).sum(1)
    return y.to(rows.dtype)


def moe_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
               use_kernels: bool = True) -> torch.Tensor:
    """Decode-time MoE on x (B, D): the same dispatch with a one-token
    sequence: the expert buffers hold a few tokens (capacity 8 at batch 1;
    dropless, at most 8 tokens take these buffers too), and the kernel
    reads only the weights of the experts that hold a token; dropless
    over more tokens, the B*k sorted rows read only the experts they route
    to. Weight-bandwidth-bound."""
    y, _ = moe_block(p, cfg, x[:, None, :], use_kernels=use_kernels)
    return y[:, 0, :]


def moe_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    E = cfg.experts_per_token if active_only else cfg.num_experts
    n = cfg.d_model * cfg.num_experts  # router
    n += E * 3 * cfg.d_model * cfg.d_ff
    n += 3 * cfg.d_model * cfg.shared_d_ff
    return n
