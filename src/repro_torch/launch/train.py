"""Training launcher: train a reduced arch with the full substrate (data
pipeline, AdamW, checkpointing) on the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      [--steps 100] [--batch 4] [--seq 128] [--ckpt-dir DIR] [--resume CKPT] \
      [--device cpu]

The flags are ``repro/launch/train.py``'s, plus ``--device`` (the card by
default). ``--arch`` takes every architecture of the port's registry;
the ssm and hybrid families round ``--seq`` down to whole SSD chunks, a
vlm trains behind zero patch embeddings, and whisper-tiny (audio) caps
``--seq`` at its 448 decoder positions and encodes zero frame embeddings
of shape (batch, encoder_seq, d_model), as the reference's launcher
does. An unknown ``--arch`` exits with status 2.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_reduced_config
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoopConfig, train


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        cfg = get_reduced_config(args.arch)
    except ValueError as exc:
        ap.error(str(exc))
    seq = args.seq
    if cfg.family in ("ssm", "hybrid"):
        seq = max(cfg.ssm_chunk, seq // cfg.ssm_chunk * cfg.ssm_chunk)
    if cfg.is_encoder_decoder:
        seq = min(seq, cfg.max_target_positions)
    print(f"training {cfg.name} (reduced, {cfg.family}) seq={seq} on {args.device}")

    def extra(step):
        out = {}
        if cfg.family == "vlm":
            out["patch_embeds"] = torch.zeros((args.batch, cfg.frontend_tokens, cfg.d_model),
                                              dtype=cfg.torch_dtype)
        if cfg.is_encoder_decoder:
            out["frame_embeds"] = torch.zeros((args.batch, cfg.encoder_seq, cfg.d_model),
                                              dtype=cfg.torch_dtype)
        return out

    h = train(
        cfg,
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                            batch_size=args.batch, seed=args.seed),
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                            total_steps=args.steps),
        loop=TrainLoopConfig(steps=args.steps, log_every=10,
                             ckpt_every=max(args.steps // 2, 50),
                             ckpt_dir=args.ckpt_dir, seed=args.seed),
        resume_from=args.resume,
        extra_batch_fn=extra if cfg.family == "vlm" or cfg.is_encoder_decoder else None,
        device=args.device,
    )
    print(f"loss {h['loss'][0]:.3f} -> {h['loss'][-1]:.3f}")
    return h


if __name__ == "__main__":
    main()
