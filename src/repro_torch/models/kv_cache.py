"""Decode-cache helpers (port of ``repro/models/kv_cache.py``).

The dense and moe models keep ``k`` and ``v`` as ``(La, B, W, Hkv, hd)``
and ``pos`` as ``(B,)`` int32, the tokens written so far. The ssm model
keeps ``conv`` as ``(Ls, B, K-1, conv_dim)`` and ``ssd`` as
``(Ls, B, H, P, N)`` float32 (see :mod:`repro_torch.models.ssm`); the
hybrid keeps both, with one ``k``/``v`` slot per application of its
shared attention block; the hybrid_moe (granite) keeps K/V for its
attention layers only and SSD / conv state for its Mamba2 layers only,
layer i in slot ``layer_slots(cfg)[i]`` of its kind. ``La`` and ``Ls``
are :func:`num_attn_layers` and :func:`num_ssm_layers`. Keys are RoPE'd at their absolute position
before caching, so ring slots stay consistent. The audio model (whisper)
has no RoPE; its cache adds the cross-attention's ``xk``/``xv`` as
``(L, B, encoder_seq, Hkv, hd)``, written once at prefill and read whole
at every step (reference ``kv_cache.py:63-65``), with the decode kernel's
mask over them (``models.model._cross_cache``).

Unlike the reference's functional updates, :func:`ring_write` and
:func:`write_prefill` write into the buffer they are given: a decode step
then touches one row per sequence instead of copying the whole cache.
The values written are those of both of the reference's ring modes
(``set_ring_mode("onehot"|"scatter")``, which differ only in how GSPMD
shards them): one in-place indexed write has no such choice to make, so
the switch is not ported.

:func:`cache_shapes` is the reference's: (shape, dtype) per cache key at
a :class:`ShapeConfig`, W the shape's effective window. :func:`init_cache`
allocates those buffers (a one-card ``batch`` may replace the shape's
global batch), filled from a generator where one is given: a decode step
over an all-zero cache would test nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, effective_decode_window

CacheShapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def conv_dim(cfg: ModelConfig) -> int:
    """Channels entering Mamba2's causal conv: x plus B and C (n_groups = 1)."""
    return cfg.d_inner + 2 * cfg.ssm_state


def num_attn_layers(cfg: ModelConfig) -> int:
    """Attention caches a model keeps: one per layer, or for the hybrid one
    per application of its shared block (every ``attn_every`` layers)."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return cfg.num_layers
    if cfg.family == "hybrid":
        return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every
    if cfg.family == "hybrid_moe":
        return cfg.layer_types.count("attention")
    return 0


def num_ssm_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid_moe":
        return cfg.layer_types.count("mamba")
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def layer_slots(cfg: ModelConfig) -> Tuple[int, ...]:
    """A hybrid_moe model's layer i's index among the layers of its own
    kind (``cfg.layer_types[i]``): its slot in that kind's stacked weights
    and in that kind's cache."""
    seen: Dict[str, int] = {}
    out = []
    for kind in cfg.layer_types:
        out.append(seen.get(kind, 0))
        seen[kind] = out[-1] + 1
    return tuple(out)


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig) -> CacheShapes:
    """(shape, dtype) of each decode-cache buffer, under the reference's
    keys, at the shape's global batch and effective window."""
    B = shape.global_batch
    W = effective_decode_window(cfg, shape)
    dt = cfg.torch_dtype
    out: CacheShapes = {"pos": ((B,), torch.int32)}
    La, Ls = num_attn_layers(cfg), num_ssm_layers(cfg)
    if La:
        out["k"] = ((La, B, W, cfg.num_kv_heads, cfg.head_dim), dt)
        out["v"] = ((La, B, W, cfg.num_kv_heads, cfg.head_dim), dt)
    if Ls:
        out["conv"] = ((Ls, B, cfg.conv_width - 1, conv_dim(cfg)), dt)
        out["ssd"] = ((Ls, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), torch.float32)
    if cfg.is_encoder_decoder:
        xshape = (cfg.num_layers, B, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        out["xk"] = (xshape, dt)
        out["xv"] = (xshape, dt)
    return out


def init_cache(cfg: ModelConfig, shape: ShapeConfig, *, batch: Optional[int] = None,
               device="cuda", generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """The decode cache of :func:`cache_shapes` on ``device``, ``batch``
    sequences (the shape's global batch by default). Without a generator
    every buffer is 0; with one, K/V, conv windows and SSD states hold
    standard normal values drawn from it. ``pos`` is 0: the caller sets
    it. An audio model's cache also gets the decode kernel's mask over the
    cached frames (``cross_positions``, ``cross_valid``, ``cross_q_pos``:
    every frame live), which the port's decode step reads."""
    from repro_torch.models.layers import _normal

    if batch is not None:
        shape = ShapeConfig(shape.name, shape.seq_len, batch, shape.kind)
    cache = {}
    for name, (shp, dtype) in cache_shapes(cfg, shape).items():
        if generator is None or name == "pos":
            cache[name] = torch.zeros(shp, dtype=dtype, device=device)
        else:
            cache[name] = _normal(generator, shp, 1.0, dtype, device)
    if cfg.is_encoder_decoder:
        cache.update(cross_mask(shape.global_batch, cfg.encoder_seq, device))
    return cache


def cross_mask(batch: int, encoder_seq: int, device) -> Dict[str, torch.Tensor]:
    """The decode kernel's mask inputs over an audio model's cached frames:
    every frame valid at positions 0..encoder_seq-1, the query at
    encoder_seq-1, so every frame is live."""
    kw = dict(device=device)
    return {
        "cross_positions": torch.arange(encoder_seq, dtype=torch.int32, **kw)[None].repeat(
            batch, 1),
        "cross_valid": torch.ones((batch, encoder_seq), dtype=torch.bool, **kw),
        "cross_q_pos": torch.full((batch,), encoder_seq - 1, dtype=torch.int32, **kw),
    }


def ring_index(pos: torch.Tensor, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, slots): the index of each batch row's next ring slot, ``pos % W``.
    pos: (B,) int32 -> two (B,) int64."""
    slot = torch.remainder(pos, W).long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return rows, slot


def ring_write(buf: torch.Tensor, new: torch.Tensor,
               pos: Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """Write one entry per batch row at slot ``pos % W``, in place.

    buf: (B, W, ...); new: (B, ...) (no window axis); pos: (B,) int32, or
    its :func:`ring_index` at this W, built once for every layer's write.
    """
    index = pos if isinstance(pos, tuple) else ring_index(pos, buf.shape[1])
    buf[index] = new
    return buf


def ring_positions(pos: torch.Tensor, W: int) -> torch.Tensor:
    """Absolute position held by each ring slot *after* ``pos`` writes.

    pos: (B,) -> (B, W) int32; slots never written hold negative values.
    Slot s holds the largest p < pos with p % W == s.
    """
    slots = torch.arange(W, dtype=torch.int32, device=pos.device)[None, :]
    p = pos[:, None].to(torch.int32)
    base = torch.div(p - 1 - slots, W, rounding_mode="floor") * W + slots
    return torch.where(base > p - 1, base - W, base).to(torch.int32)


def ring_valid(pos: torch.Tensor, W: int) -> torch.Tensor:
    """Which ring slots contain live history. pos: (B,) -> (B, W) bool."""
    return ring_positions(pos, W) >= 0


def write_prefill(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Fill one layer's cache with the last W entries of a prefill segment,
    in place. buf: (B, W, ...); new: (B, S, ...). The slot layout matches
    what ring_write gives after S sequential writes."""
    W = buf.shape[1]
    S = new.shape[1]
    if S <= W:
        buf[:, :S] = new
        return buf
    # position p goes to slot p % W: the last W entries, rotated by S % W
    r = S % W
    buf[:, r:] = new[:, S - W:S - r]
    if r:
        buf[:, :r] = new[:, S - r:]
    return buf
