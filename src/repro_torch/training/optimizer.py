"""AdamW with optional bf16 moments, gradient clipping and a warmup +
cosine schedule, as plain functions on dicts of tensors (port of
``repro/training/optimizer.py``).

The state mirrors the parameter dict with the reference's keys,
``{"step": int32 scalar, "m": {...}, "v": {...}}``, so that a checkpoint
of either package restores into the other. The update keeps the
reference's arithmetic element by element: the clipped gradient updates
the moments in float32, ``weight_decay * p`` is added to the
bias-corrected Adam direction of every tensor with two or more dimensions
(a stacked block leaf counts its layer axis, as in the reference), and
``lr`` times the result is subtracted from p.

The update runs leaf by leaf and, within a leaf, over slices of its
leading axis of at most ``SLICE_ELEMENTS`` elements (one layer of a
stacked full-width leaf), writing p, m and v in place. Only one slice's
float32 temporaries are alive at a time: a whole stacked leaf of
full-width Qwen2.5-3B takes 3.25 GB in float32, and the update holds
about six such temporaries. Every element sees the same operations either
way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.configs.base import torch_dtype

SLICE_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # bf16 moments halve optimizer memory
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` share ``tree``'s keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay; a float32 scalar."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: AdamWConfig, params) -> Dict[str, Any]:
    mdt = torch_dtype(cfg.moment_dtype)
    device = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of ``t`` along its leading axis, each of at most
    ``SLICE_ELEMENTS`` elements (at least one row)."""
    if t.ndim == 0:
        yield t
        return
    rows = max(1, SLICE_ELEMENTS // max(1, t[0].numel()))
    for start in range(0, t.shape[0], rows):
        yield t[start:start + rows]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(s.float()))
                          for x in tree_leaves(tree) for s in _slices(x)))


def _is_matrix(p: torch.Tensor) -> bool:
    # weight decay only on >=2D tensors (skips norms, biases, scalars)
    return p.ndim >= 2


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params, grads, opt_state
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. p, m and v are written in place. Returns (params,
    new_opt_state, metrics): the same parameter and moment dicts, a new
    ``step``, and the pre-clip ``grad_norm`` and the step's ``lr``."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v, decay):
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    def leaf(p, g, m, v):
        for sl in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            upd(*sl, decay=_is_matrix(p))

    tree_map(leaf, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"step": step, "m": opt_state["m"], "v": opt_state["v"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
