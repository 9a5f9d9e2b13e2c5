"""Training loop: the step, metrics, periodic checkpoints and resume (port
of ``repro/training/train_loop.py``).

A step is the reference's: :func:`forward_train` over the plain path,
its gradient (autograd here, ``jax.value_and_grad`` there), then
:func:`adamw_update`. The loop keeps the reference's history keys, log
lines, checkpoint names and cadence, and resume semantics; a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import _layer, forward_train, init_params
from repro_torch.training.checkpoint import load_checkpoint, restore_into, save_checkpoint
from repro_torch.training.data import DataConfig, SyntheticTokenPipeline
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    tree_map,
)


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    seed: int = 0
    remat: bool = False  # small models on CPU don't need it


def _step_leaves(params, grads):
    """The parameters as autograd leaves for one step, each a view of its
    parameter (so the optimizer's in-place writes reach it) whose ``.grad``
    is preset to the same view of ``grads``, into which backward adds.

    The leaves under every ``blocks`` (the model's, and the audio
    encoder's) are stacked on a layer axis; each layer's slice becomes a
    leaf of its own, and ``blocks`` a list of per-layer dicts
    (``models.model._layer`` takes either form). Indexing one stacked leaf
    per layer would instead make each layer's backward write a
    zero-filled gradient of the whole stack and add it up."""

    def leaf(p, g):
        t = p.detach().requires_grad_()
        t.grad = g
        return t

    def split(p, g):
        out = {}
        for k, v in p.items():
            if k == "blocks":
                n = len(next(iter(_leaves(v))))
                out[k] = [tree_map(leaf, _layer(v, i), _layer(g[k], i)) for i in range(n)]
            elif isinstance(v, dict):
                out[k] = split(v, g[k])
            else:
                out[k] = leaf(v, g[k])
        return out

    return split(params, grads)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def train_step(params, opt_state, batch: Dict[str, torch.Tensor], *, cfg: ModelConfig,
               opt_cfg: AdamWConfig, remat: bool):
    """One step, params and moments updated in place. Returns (params,
    opt_state, metrics): ``loss``, ``ce_loss``, ``aux_loss``, ``grad_norm``
    and ``lr``, as tensors. The gradients are freed on return."""
    grads = tree_map(torch.zeros_like, params)
    loss, metrics = forward_train(
        _step_leaves(params, grads), cfg, batch["tokens"], batch["labels"],
        patch_embeds=batch.get("patch_embeds"), frame_embeds=batch.get("frame_embeds"),
        remat=remat)
    loss.backward()
    params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return params, opt_state, dict(metrics, **opt_metrics)


def train(
    cfg: ModelConfig,
    *,
    data_cfg: DataConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    loop: Optional[TrainLoopConfig] = None,
    resume_from: Optional[str] = None,
    extra_batch_fn: Optional[Callable[[int], Dict]] = None,
    device="cuda",
) -> Dict[str, List[float]]:
    """Train on ``device``; returns the metric history (and the final
    parameters under ``final_params``). ``extra_batch_fn(step)`` may add
    inputs to a batch (a vlm's ``patch_embeds``, an audio model's
    ``frame_embeds``), as tensors or NumPy arrays."""
    loop = loop or TrainLoopConfig()
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    pipe = SyntheticTokenPipeline(data_cfg)

    params = init_params(torch.Generator(device=device).manual_seed(loop.seed), cfg)
    opt_state = init_opt_state(opt_cfg, params)
    start_step = 0
    if resume_from:
        bundle = load_checkpoint(resume_from)
        params = restore_into(params, bundle["params"])
        opt_state = restore_into(opt_state, bundle["opt_state"])
        start_step = bundle["step"]

    history: Dict[str, List[float]] = {"step": [], "loss": [], "grad_norm": [],
                                       "tokens_per_s": []}
    t_last = time.time()
    for step in range(start_step, loop.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        if extra_batch_fn is not None:
            batch.update({k: torch.as_tensor(v, device=device)
                          for k, v in extra_batch_fn(step).items()})
        params, opt_state, metrics = train_step(params, opt_state, batch, cfg=cfg,
                                                opt_cfg=opt_cfg, remat=loop.remat)
        if (step + 1) % loop.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            gn = float(metrics["grad_norm"])
            dt = time.time() - t_last
            tps = data_cfg.batch_size * data_cfg.seq_len * loop.log_every / max(dt, 1e-9)
            t_last = time.time()
            history["step"].append(step + 1)
            history["loss"].append(loss)
            history["grad_norm"].append(gn)
            history["tokens_per_s"].append(tps)
            print(f"step {step+1:5d} loss={loss:.4f} grad_norm={gn:.3f} tok/s={tps:,.0f}")
        if loop.ckpt_dir and (step + 1) % loop.ckpt_every == 0:
            path = Path(loop.ckpt_dir) / f"ckpt_{step+1:06d}.msgpack"
            save_checkpoint(str(path), step=step + 1, params=params,
                            opt_state=opt_state)
    history["final_params"] = params  # type: ignore[assignment]
    return history
