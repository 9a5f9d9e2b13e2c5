"""Model assembly for the dense, moe, vlm, ssm, hybrid and audio families:
init, full-sequence forward, the training loss, prefill and single-token
decode (port of ``repro/models/model.py``).

Per-layer parameters are stacked on a leading layer axis, as in the
reference; its ``jax.lax.scan`` over layers is a Python loop here. What
depends only on a forward's positions is built once before that loop and
read by every layer: the RoPE table (:func:`position_tables`), and in a
decode step also the ring's positions, valid mask and write index
(:func:`decode_tables`).
``use_kernels`` is the counterpart of ``use_pallas``: attention, the SSD
scan and the MoE expert products always go through
:mod:`repro_torch.kernels.ops`, which is handed the flag and picks: the
hand-written CUDA kernels for CUDA tensors while it is on (the default),
their plain versions in :mod:`repro_torch.kernels.ref` otherwise. No
function here chooses between the two. (The reference's MoE block
computes its expert products with einsum under either setting; the port
routes them to ``moe_gmm``, the same function.)

Training runs the plain path, ``use_kernels=False``, as the reference's
``train()`` does (it never passes ``use_pallas``): :func:`forward_train`
is the mean token cross-entropy over that path, differentiated by
autograd (no kernel has a backward), with the layers optionally
recomputed in the backward pass (``remat``, the reference's
``jax.checkpoint`` under its default policy: nothing is saved).
:func:`save_dots` is the selective-checkpoint policy of the reference's
``set_remat_policy("dots")`` (the outputs of 2-D matmuls kept, the
counterpart of ``dots_with_no_batch_dims_saveable``); no training path
of the port selects it yet.

``long_context`` (:func:`forward_seq`, :func:`forward_prefill`) is the
reference's long-context variant behind the long_500k shape: a model
without a native sliding window attends within ``long_context_window``
(:func:`_decoder_window`), in the plain path and in the flash kernel
alike. A decode step concatenates the token's K/V to the window before
attending, the reference's default ``"concat"`` mode; its plain
``"split"`` mode is ``layers.sdpa_decode_split``, which no decode path
of the port calls. The reference's ``set_scan_unroll`` has no counterpart: the layer loop is
plain Python, and every layer runs and is counted as written. The MoE
layers' Switch aux losses are summed as the reference's scan sums them,
and they reach the loss only through :func:`forward_train`, which asks
for them and adds ``router_aux_weight`` times the sum; no other path
computes them, so serving pays nothing for them.

The hybrid (zamba2) runs the ssm family's Mamba2 blocks and, before
every ``attn_every``-th of them, one SHARED attention + MLP block
(``params["shared_attn"]``, unstacked). Each application keeps its own
K/V cache slot, ``idx // attn_every``; only those slots are allocated
(the reference computes K/V for every layer and keeps the fired ones).

The hybrid_moe (granite 4.0-H) has no counterpart in the reference. Each
layer's mixer is Mamba2 or attention, as ``cfg.layer_types`` says; the
weights of each kind are stacked over the layers of that kind
(``params["mamba"]``, ``params["attention"]``; layer i is slot
``kv_cache.layer_slots(cfg)[i]`` of its kind, in the cache too), the
norms and the MoE (routed experts and a shared one, ``models/moe.py``)
over all layers in ``params["blocks"]``. A layer is
``x + r * mixer(rms_norm(x))``, then ``x + r * moe(rms_norm(x))``, r
the residual multiplier; the embedding is scaled by its multiplier, the
logits divided by ``logits_scaling``, the attention runs without RoPE at
the softmax scale ``attention_multiplier``. Its equations are written in
``configs/granite_4_0_h_small.py``.

The vlm (internvl2) is the dense model behind a stubbed vision
frontend: the caller's ``patch_embeds`` (B, frontend_tokens, d_model) are
prepended to the token embeddings at prefill, so the text starts at
position ``frontend_tokens`` and the decode cache counts the prefix.

The audio family (whisper) is an encoder-decoder without RoPE: a
bidirectional encoder over the caller's ``frame_embeds`` (B, encoder_seq,
d_model) plus learned ``enc_pos``, and a decoder with learned ``dec_pos``
(at most ``max_target_positions``; decode clamps the position there)
whose blocks add a cross-attention over the encoder output. Its K/V are
computed once per layer at prefill and cached (``xk``/``xv``). With
``use_kernels`` the encoder runs the flash kernel non-causally, and each
decode step's cross-attention runs the decode kernel over every frame
(all valid, query position ``encoder_seq - 1``: unmasked). The prefill's
cross-attention stays plain: no TPU kernel computes attention with more
or fewer queries than keys (the reference's flash kernel takes one S for
both, src/repro/kernels/flash_attention.py:113-121).

Five quirks of the reference are kept on purpose: positions start at 0
for every row of a batch, left-pad tokens are not masked, the vlm's pad
tokens therefore sit between the patches and the text, the shared block
takes the residual stream alone, and a whisper decode step takes its
cross-attention query from the block's normed input plus the
self-attention's output, not from the residual stream as the full
forward does (src/repro/models/model.py:547 against :213-214), so decode
is not the full forward's continuation there.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.kv_cache import (
    conv_dim,
    cross_mask,
    layer_slots,
    num_attn_layers,
    num_ssm_layers,
    ring_index,
    ring_positions,
    ring_write,
    write_prefill,
)

Params = Dict[str, Any]


FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "hybrid_moe", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r} "
                                  f"(the port has {', '.join(FAMILIES)})")


def _uses_rope(cfg: ModelConfig) -> bool:
    # whisper's positions are learned embeddings; granite's attention has none
    return cfg.family != "audio" and cfg.use_rope


class DecodeTables(NamedTuple):
    """What every attention block of one decode step reads that depends
    only on the step's positions and the ring width W (:func:`decode_tables`)."""

    pos: torch.Tensor  # (B,) int32: the token's position
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]]  # rope_table at pos; None without RoPE
    kv_pos: torch.Tensor  # (B, W + 1) int32: each ring slot's position, then the token's
    valid: torch.Tensor  # (B, W + 1) bool: the slots holding history, and the token
    slot: Tuple[torch.Tensor, torch.Tensor]  # ring_index(pos, W): where the token's K/V go


def position_tables(cfg: ModelConfig,
                    positions: torch.Tensor) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The RoPE table of a full forward's ``positions`` (B, S), built once
    for all its attention blocks; None where no block rotates (ssm, audio)."""
    if not (cfg.uses_attention and _uses_rope(cfg)):
        return None
    tracing.count("model.position_tables")
    return L.rope_table(positions, cfg.head_dim, cfg.rope_theta)


def decode_tables(cfg: ModelConfig, pos: torch.Tensor, W: int) -> DecodeTables:
    """A decode step's :class:`DecodeTables` from ``pos`` (B,), the tokens
    cached so far, at ring width W: built once a step from the cache's
    positions (in a recorded CUDA graph too, so a replay reads its own
    step's), never kept across steps. The values are those of
    ``ring_positions`` / ``ring_valid`` / ``ring_write`` and ``layers.rope``;
    the token's own column is valid as pos >= 0."""
    tracing.count("model.position_tables")
    rope = L.rope_table(pos[:, None], cfg.head_dim, cfg.rope_theta) if _uses_rope(cfg) else None
    kv_pos = torch.cat([ring_positions(pos, W), pos[:, None]], dim=1)
    return DecodeTables(pos, rope, kv_pos, kv_pos >= 0, ring_index(pos, W))


def _decoder_window(cfg: ModelConfig, long_context: bool) -> Optional[int]:
    """The decoder's attention window: the native sliding window, else the
    long-context window where ``long_context`` is set, else none."""
    if cfg.sliding_window is not None:
        return cfg.sliding_window
    if long_context:
        return cfg.long_context_window
    return None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None) -> Params:
    """Random parameters on ``device`` (``gen.device`` by default), with the
    reference's keys, shapes and scales (the values differ: another
    generator). ``device="meta"`` with a CPU generator gives the shapes
    and dtypes alone, nothing allocated (``launch.steps.eval_param_shapes``)."""
    _check_family(cfg)
    dt = cfg.torch_dtype
    dev = torch.device(device) if device is not None else gen.device
    lead = (cfg.num_layers,)
    kw = dict(lead=lead, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    if cfg.family == "hybrid_moe":
        blocks = {"norm1": ones(cfg.num_layers, cfg.d_model),
                  "norm2": ones(cfg.num_layers, cfg.d_model),
                  "moe": MOE.init_moe(gen, cfg, **kw)}
    elif cfg.uses_ssm:
        blocks = {"norm": ones(cfg.num_layers, cfg.d_model),
                  "mamba": SSM.init_mamba_block(gen, cfg, **kw)}
    else:
        blocks = {
            "norm1": ones(cfg.num_layers, cfg.d_model),
            "attn": L.init_attention(gen, cfg, **kw),
            "norm2": ones(cfg.num_layers, cfg.d_model),
        }
        if cfg.family == "moe":
            blocks["moe"] = MOE.init_moe(gen, cfg, **kw)
            if cfg.dense_residual:
                blocks["dense_mlp"] = L.init_mlp(gen, cfg, **kw)
        else:
            blocks["mlp"] = L.init_mlp(gen, cfg, **kw)
        if cfg.is_encoder_decoder:
            blocks["norm_x"] = ones(cfg.num_layers, cfg.d_model)
            blocks["xattn"] = L.init_attention(gen, cfg, **kw)
    embed = L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev)
    params = {
        "embed": embed,
        "blocks": blocks,
        "final_norm": ones(cfg.d_model),
        # a tied head is a view of the embedding, (D, V)
        "lm_head": (embed.t() if cfg.tie_embeddings
                    else L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device=dev)),
    }
    if cfg.family == "hybrid_moe":
        params["mamba"] = SSM.init_mamba_block(gen, cfg, lead=(num_ssm_layers(cfg),),
                                               device=dev)
        params["attention"] = L.init_attention(gen, cfg, lead=(num_attn_layers(cfg),),
                                               device=dev)
    if cfg.family == "hybrid":
        params["shared_attn"] = {
            "norm1": ones(cfg.d_model),
            "attn": L.init_attention(gen, cfg, device=dev),
            "norm2": ones(cfg.d_model),
            "mlp": L.init_mlp(gen, cfg, device=dev),
        }
    if cfg.is_encoder_decoder:
        enc = dict(lead=(cfg.encoder_layers,), device=dev)
        params["encoder"] = {
            "blocks": {"norm1": ones(cfg.encoder_layers, cfg.d_model),
                       "attn": L.init_attention(gen, cfg, **enc),
                       "norm2": ones(cfg.encoder_layers, cfg.d_model),
                       "mlp": L.init_mlp(gen, cfg, **enc)},
            "norm": ones(cfg.d_model),
        }
        params["enc_pos"] = L._normal(gen, (cfg.encoder_seq, cfg.d_model), 0.02, dt, dev)
        params["dec_pos"] = L._normal(gen, (cfg.max_target_positions, cfg.d_model), 0.02, dt,
                                      dev)
    return params


def _layer(blocks, i: int) -> Params:
    """Layer ``i``'s view of the stacked block parameters, or the ``i``-th
    dict where ``blocks`` is a list of per-layer dicts (as the training
    step passes them: see ``training/train_loop.py``)."""
    if isinstance(blocks, list):
        return blocks[i]
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def save_dots(ctx, op, *args, **kwargs):
    """The reference's "dots" remat policy as a selective-checkpoint policy
    (``torch.utils.checkpoint.create_selective_checkpoint_contexts(save_dots)``):
    keep 2-D matmul outputs (a layer's projections, never the batched
    attention products), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` its activations are recomputed in the
    backward pass instead of kept."""
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------


def _attn_full(
    bp: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    window: Optional[int],
    use_kernels: bool,
    enc_out: Optional[torch.Tensor] = None,
    want_aux: bool = False,
):
    """One attention (+ cross-attention over ``enc_out``, where given) +
    MLP (or MoE) block over a full sequence; q and k rotated by ``rope``
    (:func:`position_tables`) where it is given.

    Returns (x, aux, kv): the MoE layer's Switch aux loss where
    ``want_aux`` asks for it (else, and in the other families, None), and
    for cache writing (k, v), the K RoPE'd outside the
    audio family, followed by the cross-attention's (xk, xv) over
    ``enc_out`` where it is given.
    """
    h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = L.attn_qkv(bp["attn"], cfg, h)
    if rope is not None:
        q = L.apply_rope(q, *rope)
        k = L.apply_rope(k, *rope)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            scale=cfg.attention_multiplier, use_kernels=use_kernels)
    x = x + L.attn_out(bp["attn"], cfg, o)
    kv = (k, v)
    if enc_out is not None:
        x, xk, xv = _cross_full(bp, cfg, x, enc_out)
        kv += (xk, xv)
    h2 = L.rms_norm(x, bp["norm2"], cfg.norm_eps)
    aux = None
    if cfg.family == "moe":
        y, aux = MOE.moe_block(bp["moe"], cfg, h2, use_kernels=use_kernels, aux=want_aux)
        if cfg.dense_residual:
            y = y + L.mlp(bp["dense_mlp"], cfg, h2)
    else:
        y = L.mlp(bp["mlp"], cfg, h2)
    return x + y, aux, kv


def _cross_full(bp: Params, cfg: ModelConfig, x: torch.Tensor, enc_out: torch.Tensor):
    """A decoder block's cross-attention over a whole target sequence: the
    query from ``rms_norm(x, norm_x)``, K/V from the encoder output, every
    frame live. Plain on every device: no TPU kernel computes attention
    with Sq != Skv. Returns (x, xk, xv)."""
    qx = L.attn_q(bp["xattn"], cfg, L.rms_norm(x, bp["norm_x"], cfg.norm_eps))
    xk, xv = L.attn_kv(bp["xattn"], cfg, enc_out)
    ox = L.sdpa(qx, xk, xv, causal=False)
    return x + L.attn_out(bp["xattn"], cfg, ox), xk, xv


def _encoder_block(bp: Params, cfg: ModelConfig, x: torch.Tensor,
                   use_kernels: bool) -> torch.Tensor:
    """One bidirectional attention + MLP block of the audio encoder."""
    q, k, v = L.attn_qkv(bp["attn"], cfg, L.rms_norm(x, bp["norm1"], cfg.norm_eps))
    o = ops.flash_attention(q, k, v, causal=False, use_kernels=use_kernels)
    x = x + L.attn_out(bp["attn"], cfg, o)
    return x + L.mlp(bp["mlp"], cfg, L.rms_norm(x, bp["norm2"], cfg.norm_eps))


def _run_encoder(params: Params, cfg: ModelConfig, frame_embeds: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """The encoder output (B, encoder_seq, d_model). ``frame_embeds`` are
    taken in the weights' dtype (the engine makes them so)."""
    enc = params["encoder"]
    x = frame_embeds.to(params["enc_pos"].dtype) + params["enc_pos"][None]
    for i in range(cfg.encoder_layers):
        x = _encoder_block(_layer(enc["blocks"], i), cfg, x, use_kernels)
    return L.rms_norm(x, enc["norm"], cfg.norm_eps)


def _ssm_full(bp: Params, shared: Optional[Params], cfg: ModelConfig, x: torch.Tensor,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]], window: Optional[int],
              use_kernels: bool):
    """One Mamba2 layer over a full sequence, after the hybrid's shared
    block where ``shared`` is given (the shared block takes the residual
    stream alone, as the reference's code does: src/repro/models/model.py:350).

    Returns (x, (k_rope, v) of the shared block or None, final SSD state,
    conv tail)."""
    kv = None
    if shared is not None:
        x, _, kv = _attn_full(shared, cfg, x, rope, window, use_kernels)
    u = L.rms_norm(x, bp["norm"], cfg.norm_eps)
    out, ssd_state, conv_tail = SSM.mamba_block(bp["mamba"], cfg, u, use_kernels=use_kernels)
    return x + out, kv, ssd_state, conv_tail


def _hybrid_moe_full(bp: Params, mp: Params, kind: str, cfg: ModelConfig, x: torch.Tensor,
                     window: Optional[int], use_kernels: bool, want_aux: bool):
    """One hybrid_moe layer over a full sequence: the ``kind`` mixer on
    its weights ``mp`` (Mamba2, or attention without RoPE), then the
    routed and shared experts, each branch scaled by the residual
    multiplier.

    Returns (x, the Switch aux loss where asked, else None, the state for
    the cache: (k, v) of an attention layer, (final SSD state, conv tail)
    of a Mamba2 one)."""
    r = cfg.residual_multiplier
    h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
    if kind == "mamba":
        out, ssd_state, conv_tail = SSM.mamba_block(mp, cfg, h, use_kernels=use_kernels)
        state = (ssd_state, conv_tail)
    else:
        q, k, v = L.attn_qkv(mp, cfg, h)
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                scale=cfg.attention_multiplier, use_kernels=use_kernels)
        out, state = L.attn_out(mp, cfg, o), (k, v)
    x = x + out * r
    y, aux = MOE.moe_block(bp["moe"], cfg, L.rms_norm(x, bp["norm2"], cfg.norm_eps),
                           use_kernels=use_kernels, aux=want_aux)
    return x + y * r, aux, state


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the output head, divided by ``logits_scaling``
    where the config scales its logits."""
    logits = L.rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["lm_head"]
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if cfg.family == "vlm":
        if patch_embeds is None:
            raise ValueError(f"{cfg.name}: a vlm forward needs patch_embeds")
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patch_embeds: Optional[torch.Tensor] = None,
    frame_embeds: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    cache_window: Optional[int] = None,
    long_context: bool = False,
    use_kernels: bool = True,
    remat: bool = False,
    want_aux: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """:func:`forward_seq`, also returning the MoE layers' aux losses where
    ``want_aux`` asks for them (a list, empty outside the moe family and
    when not asked); ``remat`` recomputes each decoder layer in the
    backward pass."""
    _check_family(cfg)
    window = _decoder_window(cfg, long_context)
    enc_out = None
    if cfg.is_encoder_decoder:
        if tokens.shape[1] > cfg.max_target_positions:
            raise ValueError(f"{cfg.name}: {tokens.shape[1]} target positions exceed "
                             f"max_target_positions {cfg.max_target_positions}")
        if frame_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs frame_embeds")
        enc_out = _run_encoder(params, cfg, frame_embeds, use_kernels)
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    Bsz, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(Bsz, S)
    rope = position_tables(cfg, positions)
    if enc_out is not None:
        x = x + params["dec_pos"][:S][None]
    auxes: List[torch.Tensor] = []
    cache: Optional[Dict[str, torch.Tensor]] = {} if want_cache else None
    if cache is not None and cfg.uses_attention:
        shape = (num_attn_layers(cfg), Bsz, cache_window or S, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cache["v"] = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if cache is not None and enc_out is not None:
        cache.update(_cross_cache(cfg, enc_out))
    if cfg.uses_ssm and cache is not None:
        Ls = num_ssm_layers(cfg)
        cache["ssd"] = torch.empty((Ls, Bsz, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                   dtype=torch.float32, device=x.device)
        cache["conv"] = torch.empty((Ls, Bsz, cfg.conv_width - 1, conv_dim(cfg)),
                                    dtype=x.dtype, device=x.device)
    if cfg.family == "hybrid_moe":
        for i, (kind, slot) in enumerate(zip(cfg.layer_types, layer_slots(cfg))):
            x, aux, state = _run(remat, _hybrid_moe_full, _layer(params["blocks"], i),
                                 _layer(params[kind], slot), kind, cfg, x, window,
                                 use_kernels, want_aux)
            if aux is not None:
                auxes.append(aux)
            if cache is None:
                continue
            if kind == "attention":
                write_prefill(cache["k"][slot], state[0])
                write_prefill(cache["v"][slot], state[1])
            else:
                cache["ssd"][slot], cache["conv"][slot] = state
    elif cfg.uses_ssm:
        for i in range(cfg.num_layers):
            fires = cfg.family == "hybrid" and i % cfg.attn_every == 0
            x, kv, ssd_state, conv_tail = _run(
                remat, _ssm_full, _layer(params["blocks"], i),
                params["shared_attn"] if fires else None, cfg, x, rope, window, use_kernels)
            if cache is not None:
                if fires:
                    write_prefill(cache["k"][i // cfg.attn_every], kv[0])
                    write_prefill(cache["v"][i // cfg.attn_every], kv[1])
                cache["ssd"][i] = ssd_state
                cache["conv"][i] = conv_tail
    else:
        for i in range(cfg.num_layers):
            x, aux, (k, v, *cross) = _run(remat, _attn_full, _layer(params["blocks"], i),
                                          cfg, x, rope, window, use_kernels, enc_out,
                                          want_aux)
            if aux is not None:
                auxes.append(aux)
            if cache is not None:
                write_prefill(cache["k"][i], k)
                write_prefill(cache["v"][i], v)
                if cross:
                    cache["xk"][i], cache["xv"][i] = cross
    logits = _head(params, cfg, x)
    if cache is not None:
        cache["pos"] = torch.full((Bsz,), S, dtype=torch.int32, device=x.device)
    return logits, auxes, cache


def _cross_cache(cfg: ModelConfig, enc_out: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The audio decode cache's cross-attention part, filled layer by layer
    at prefill: ``xk``/``xv`` (L, B, encoder_seq, Hkv, hd), each layer's
    slice contiguous for the decode kernel; and the kernel's mask inputs
    (``kv_cache.cross_mask``), built once here rather than per layer per
    step."""
    Bsz, S_enc, _ = enc_out.shape
    shape = (cfg.num_layers, Bsz, S_enc, cfg.num_kv_heads, cfg.head_dim)
    return {
        "xk": torch.empty(shape, dtype=enc_out.dtype, device=enc_out.device),
        "xv": torch.empty(shape, dtype=enc_out.dtype, device=enc_out.device),
        **cross_mask(Bsz, S_enc, enc_out.device),
    }


def forward_seq(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patch_embeds: Optional[torch.Tensor] = None,
    frame_embeds: Optional[torch.Tensor] = None,
    want_cache: bool = False,
    cache_window: Optional[int] = None,
    long_context: bool = False,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence forward. Returns (logits, cache|None).

    With ``want_cache`` the per-layer state for subsequent decode is
    collected: for an attention layer the RoPE'd K/V (last ``cache_window``
    entries, in ring layout, (La,B,W,Hkv,hd)); for an ssm layer the final
    SSD state (``ssd``, (L,B,H,P,N) float32) and the raw pre-conv inputs of
    the last K-1 tokens (``conv``, (L,B,K-1,conv_dim)). The hybrid keeps
    both, its K/V slot ``a`` holding the shared block's ``a``-th application.
    A vlm takes ``patch_embeds`` (B, frontend_tokens, d_model) before the
    tokens; the logits then cover the patches too. The audio family takes
    ``frame_embeds`` (B, encoder_seq, d_model) for its encoder and at most
    ``max_target_positions`` tokens (more raise before anything is
    computed); its cache adds the cross-attention's ``xk``/``xv`` per layer
    and the decode kernel's mask over them (``cross_positions``,
    ``cross_valid``, ``cross_q_pos``). The MoE aux losses are not
    computed (:func:`forward_train` asks for them and adds them to the loss). ``long_context`` runs
    the long-context variant (see :func:`_decoder_window`).
    """
    logits, _, cache = _forward(params, cfg, tokens, patch_embeds=patch_embeds,
                                frame_embeds=frame_embeds, want_cache=want_cache,
                                cache_window=cache_window, long_context=long_context,
                                use_kernels=use_kernels)
    return logits, cache


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy: the log-sum-exp of the float32 logits
    (max subtracted) minus the gold logit. logits (..., V), labels (...)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def forward_train(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    patch_embeds: Optional[torch.Tensor] = None,
    frame_embeds: Optional[torch.Tensor] = None,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (scalar loss, {"ce_loss", "aux_loss"}) over the plain path:
    the mean cross-entropy of the next-token ``labels`` (a vlm's patch
    positions cut from the logits first) plus ``router_aux_weight`` times
    the MoE layers' summed aux loss (0 outside the moe family)."""
    logits, auxes, _ = _forward(params, cfg, tokens, patch_embeds=patch_embeds,
                                frame_embeds=frame_embeds, use_kernels=False, remat=remat,
                                want_aux=True)
    if cfg.family == "vlm":
        logits = logits[:, cfg.frontend_tokens:]
    loss = torch.mean(cross_entropy(logits, labels))
    aux = (torch.stack(auxes).sum() if auxes
           else torch.zeros((), dtype=torch.float32, device=logits.device))
    total = loss + cfg.router_aux_weight * aux
    return total, {"ce_loss": loss, "aux_loss": aux}


def forward_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    patch_embeds: Optional[torch.Tensor] = None,
    frame_embeds: Optional[torch.Tensor] = None,
    cache_window: Optional[int] = None,
    long_context: bool = False,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (last-position logits: (B, V), cache)."""
    logits, cache = forward_seq(params, cfg, tokens, patch_embeds=patch_embeds,
                                frame_embeds=frame_embeds, want_cache=True,
                                cache_window=cache_window, long_context=long_context,
                                use_kernels=use_kernels)
    return logits[:, -1], cache


# ---------------------------------------------------------------------------
# Decode (one token against the cache)
# ---------------------------------------------------------------------------


def _attn_decode(
    bp: Params,
    cfg: ModelConfig,
    x_t: torch.Tensor,  # (B, D)
    k_buf: torch.Tensor,  # (B, W, Hkv, hd)
    v_buf: torch.Tensor,
    tables: DecodeTables,
    use_kernels: bool,
    cross: Optional[Tuple[torch.Tensor, ...]] = None,
):
    """Single-token attention against a ring-buffer cache, in the
    reference's default ``"concat"`` mode: the current token's K/V join
    the window as slot W before attending; then the cross-attention term
    where ``cross`` is given (see :func:`_cross_decode`).

    Returns (out: (B,D), new_k: (B,Hkv,hd), new_v).
    """
    q, k, v = L.attn_qkv(bp["attn"], cfg, x_t[:, None])
    if tables.rope is not None:
        q = L.apply_rope(q, *tables.rope)
        k = L.apply_rope(k, *tables.rope)
    k_all = torch.cat([k_buf, k], dim=1)
    v_all = torch.cat([v_buf, v], dim=1)
    o = ops.decode_attention(q, k_all, v_all, tables.kv_pos, tables.valid, tables.pos,
                             scale=cfg.attention_multiplier, use_kernels=use_kernels)
    out = L.attn_out(bp["attn"], cfg, o)[:, 0]
    if cross is not None:
        out = out + _cross_decode(bp, cfg, x_t + out, cross, use_kernels)
    return out, k[:, 0], v[:, 0]


def _cross_decode(bp: Params, cfg: ModelConfig, x: torch.Tensor,
                  cross: Tuple[torch.Tensor, ...], use_kernels: bool) -> torch.Tensor:
    """A decode step's cross-attention term (B, D) over the cached encoder
    K/V. ``x`` is the block's normed input plus its self-attention output,
    the reference's quirk (src/repro/models/model.py:547). ``cross`` is
    (xk, xv, cross_positions, cross_valid, cross_q_pos) from the cache: the
    decode attention attends to every frame (all valid, each at or before
    the query's position), unmasked."""
    xk, xv, kv_positions, kv_valid, q_pos = cross
    qx = L.attn_q(bp["xattn"], cfg, L.rms_norm(x, bp["norm_x"], cfg.norm_eps)[:, None])
    ox = ops.decode_attention(qx, xk, xv, kv_positions, kv_valid, q_pos,
                              use_kernels=use_kernels)
    return L.attn_out(bp["xattn"], cfg, ox)[:, 0]


def _block_decode(
    bp: Params,
    cfg: ModelConfig,
    x: torch.Tensor,  # (B, D)
    k_buf: torch.Tensor,  # (B, W, Hkv, hd), written in place
    v_buf: torch.Tensor,
    tables: DecodeTables,
    use_kernels: bool,
    cross: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """One attention (+ cross-attention) + MLP (or MoE) block for one
    token; the token's K/V go into its ring slot right after the
    attention. The buffers are read by this block alone (a layer's, or one
    application's of the hybrid's shared block), so that equals the
    reference's write after the scan."""
    a = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
    o, nk, nv = _attn_decode(bp, cfg, a, k_buf, v_buf, tables, use_kernels, cross)
    ring_write(k_buf, nk, tables.slot)
    ring_write(v_buf, nv, tables.slot)
    x = x + o
    h2 = L.rms_norm(x, bp["norm2"], cfg.norm_eps)
    if cfg.family == "moe":
        y = MOE.moe_decode(bp["moe"], cfg, h2, use_kernels=use_kernels)
        if cfg.dense_residual:
            y = y + L.mlp(bp["dense_mlp"], cfg, h2)
    else:
        y = L.mlp(bp["mlp"], cfg, h2)
    return x + y


def forward_decode(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B,) int32
    cache: Dict[str, torch.Tensor],
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. Returns (logits: (B, V), cache). The K/V buffers,
    conv windows and SSD states are updated in place; ``pos`` is replaced
    by ``pos + 1``. The audio family adds its learned position, clamped to
    ``max_target_positions - 1``, and attends to the cached encoder K/V."""
    _check_family(cfg)
    pos = cache["pos"]
    x = params["embed"][token]  # (B, D)
    if cfg.is_encoder_decoder:
        x = x + params["dec_pos"][torch.clamp(pos, 0, cfg.max_target_positions - 1).long()]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    tables = decode_tables(cfg, pos, cache["k"].shape[2]) if cfg.uses_attention else None
    slots = layer_slots(cfg)
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        if cfg.family == "hybrid_moe":
            kind = cfg.layer_types[i]
            x = _hybrid_moe_decode(bp, _layer(params[kind], slots[i]), kind, cfg, x, cache,
                                   slots[i], tables, use_kernels)
            continue
        if not cfg.uses_ssm:
            cross = None
            if cfg.is_encoder_decoder:
                cross = (cache["xk"][i], cache["xv"][i], cache["cross_positions"],
                         cache["cross_valid"], cache["cross_q_pos"])
            x = _block_decode(bp, cfg, x, cache["k"][i], cache["v"][i], tables, use_kernels,
                              cross)
            continue
        if cfg.family == "hybrid" and i % cfg.attn_every == 0:
            app = i // cfg.attn_every
            x = _block_decode(params["shared_attn"], cfg, x, cache["k"][app],
                              cache["v"][app], tables, use_kernels)
        u = L.rms_norm(x, bp["norm"], cfg.norm_eps)
        out, _, _ = SSM.mamba_decode(bp["mamba"], cfg, u, cache["conv"][i], cache["ssd"][i])
        x = x + out
    logits = _head(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache


def _hybrid_moe_decode(bp: Params, mp: Params, kind: str, cfg: ModelConfig, x: torch.Tensor,
                       cache: Dict[str, torch.Tensor], slot: int, tables: DecodeTables,
                       use_kernels: bool) -> torch.Tensor:
    """One hybrid_moe layer for one token x (B, D): the ``kind`` mixer on
    its weights ``mp`` and its ``slot`` of that kind's cache (attention
    against its ring, the token's K/V written into it right after; Mamba2
    on its conv window and SSD state, in place), then the experts."""
    r = cfg.residual_multiplier
    h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
    if kind == "mamba":
        out, _, _ = SSM.mamba_decode(mp, cfg, h, cache["conv"][slot], cache["ssd"][slot])
    else:
        out, nk, nv = _attn_decode({"attn": mp}, cfg, h, cache["k"][slot], cache["v"][slot],
                                   tables, use_kernels)
        ring_write(cache["k"][slot], nk, tables.slot)
        ring_write(cache["v"][slot], nv, tables.slot)
    x = x + out * r
    y = MOE.moe_decode(bp["moe"], cfg, L.rms_norm(x, bp["norm2"], cfg.norm_eps),
                       use_kernels=use_kernels)
    return x + y * r


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg`` from its fields alone; ``active_only`` counts
    ``experts_per_token`` of a moe layer's experts (its router whole)."""
    _check_family(cfg)
    D = cfg.d_model
    attn_mlp = 2 * D + L.attn_param_count(cfg) + L.mlp_param_count(cfg)
    extra = 0
    if cfg.family == "hybrid_moe":  # norms and experts a layer; each mixer kind's layers
        per = 2 * D + MOE.moe_param_count(cfg, active_only)
        extra = (num_attn_layers(cfg) * L.attn_param_count(cfg)
                 + num_ssm_layers(cfg) * SSM.mamba_param_count(cfg))
    elif cfg.uses_ssm:
        per = D + SSM.mamba_param_count(cfg)
        if cfg.family == "hybrid":  # the shared attention block, counted once
            extra = attn_mlp
    elif cfg.family == "moe":
        per = 2 * D + L.attn_param_count(cfg) + MOE.moe_param_count(cfg, active_only)
        if cfg.dense_residual:
            per += L.mlp_param_count(cfg)
    elif cfg.family == "audio":  # + norm_x and xattn; the encoder, its norm, positions
        per = attn_mlp + D + L.attn_param_count(cfg)
        extra = (cfg.encoder_layers * attn_mlp + D
                 + (cfg.encoder_seq + cfg.max_target_positions) * D)
    else:  # dense and vlm (its frontend is a stub without parameters)
        per = attn_mlp
    embeddings = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)
    return embeddings + D + cfg.num_layers * per + extra
