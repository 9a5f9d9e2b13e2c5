"""Train a ~100M-parameter dense model for a few hundred steps on the
port (``examples/train_small.py`` on PyTorch) with the full substrate:
synthetic data pipeline, AdamW + cosine schedule, grad clipping,
periodic checkpointing, and resume.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 200] [--device cpu]

It trains on the card by default; ``--device cpu`` runs it on the CPU.
"""

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import TrainLoopConfig, train


def model_100m() -> ModelConfig:
    """~100M params: 12L d=512 8H swiglu, 32k vocab (qwen-family shape)."""
    return ModelConfig(
        name="dense-100m", family="dense", source="examples/train_small",
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32_000, mlp_type="swiglu",
        rope_theta=10_000.0,
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train_small_torch"))
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = model_100m()
    print(f"model: {cfg.name} ~{cfg.param_count()/1e6:.0f}M params on {args.device}")
    history = train(
        cfg,
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            batch_size=args.batch, seed=0),
        opt_cfg=AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps),
        loop=TrainLoopConfig(steps=args.steps, log_every=10,
                             ckpt_every=100, ckpt_dir=args.ckpt_dir),
        resume_from=args.resume,
        device=args.device,
    )
    first, last = history["loss"][0], history["loss"][-1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
