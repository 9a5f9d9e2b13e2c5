"""Decode-cache helpers (port of ``repro/models/kv_cache.py``).

The dense and moe models keep ``k`` and ``v`` as ``(La, B, W, Hkv, hd)``
and ``pos`` as ``(B,)`` int32, the tokens written so far. The ssm model
keeps ``conv`` as ``(Ls, B, K-1, conv_dim)`` and ``ssd`` as
``(Ls, B, H, P, N)`` float32 (see :mod:`repro_torch.models.ssm`); the
hybrid keeps both, with one ``k``/``v`` slot per application of its
shared attention block. ``La`` and ``Ls`` are :func:`num_attn_layers` and
:func:`num_ssm_layers`. Keys are RoPE'd at their absolute position
before caching, so ring slots stay consistent. The audio model (whisper)
has no RoPE; its cache adds the cross-attention's ``xk``/``xv`` as
``(L, B, encoder_seq, Hkv, hd)``, written once at prefill and read whole
at every step (reference ``kv_cache.py:63-65``), with the decode kernel's
mask over them (``models.model._cross_cache``).

Unlike the reference's functional updates, :func:`ring_write` and
:func:`write_prefill` write into the buffer they are given: a decode step
then touches one row per sequence instead of copying the whole cache.
The values written are those of the reference's one-hot formulation.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


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
    return 0


def num_ssm_layers(cfg: ModelConfig) -> int:
    return cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0


def ring_write(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Write one entry per batch row at slot ``pos % W``, in place.

    buf: (B, W, ...); new: (B, ...) (no window axis); pos: (B,) int32.
    """
    slot = torch.remainder(pos, buf.shape[1]).long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    buf[rows, slot] = new
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
    abs_pos = torch.arange(S - W, S, device=new.device)
    buf[:, abs_pos % W] = new[:, S - W:]
    return buf
