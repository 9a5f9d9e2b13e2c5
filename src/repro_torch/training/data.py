"""Synthetic token data pipeline (a copy of ``repro/training/data.py``:
plain NumPy, so ``batch_at(step)`` gives the reference's arrays).

A deterministic, seekable stream of language-model batches: documents
are sampled from a Zipfian unigram-with-bigram-structure generator (so
the loss actually decreases during the example training runs — a model
can learn the bigram statistics), packed to fixed-length sequences, and
served as (tokens, labels) with next-token labels. Restartable from a
step index for checkpoint resume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    # bigram structure strength: 0 = iid tokens, 1 = fully deterministic
    bigram_strength: float = 0.7
    n_bigram_states: int = 64


class SyntheticTokenPipeline:
    """Deterministic batch source; ``batch_at(step)`` is random-access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # zipfian unigram distribution
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks**1.1)
        self._unigram /= self._unigram.sum()
        # latent bigram chain: each state prefers a band of tokens
        S = cfg.n_bigram_states
        self._state_of_token = root.integers(0, S, size=V)
        self._next_state = root.integers(0, S, size=S)
        self._band = root.integers(0, V - 16, size=S)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, L, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, L + 1), np.int32)
        toks[:, 0] = rng.choice(V, size=B, p=self._unigram)
        for t in range(1, L + 1):
            prev_state = self._state_of_token[toks[:, t - 1]]
            nxt = self._next_state[prev_state]
            band_tok = self._band[nxt] + rng.integers(0, 16, size=B)
            iid_tok = rng.choice(V, size=B, p=self._unigram)
            use_band = rng.random(B) < cfg.bigram_strength
            toks[:, t] = np.where(use_band, band_tok, iid_tok)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
