"""Serving engine of the port: batched prefill + greedy decode.

Port of ``repro/serving/engine.py``. Prompts are left-padded into one
batch (pads are token 0 and are not masked, positions start at 0: the
reference's behaviour, kept), the ring cache is prefilled, then each
step decodes one token per sequence greedily. Attention runs through the
hand-written CUDA kernels (``use_kernels``, on by default) when the
engine's device is CUDA.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import forward_decode, forward_prefill, init_params


@dataclasses.dataclass
class GenerationResult:
    tokens: List[List[int]]
    prefill_s: float
    decode_s: float
    tokens_per_s: float


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, cache_window: int = 256,
                 seed: int = 0, use_kernels: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        self.params = params
        self.cache_window = cache_window
        self.use_kernels = use_kernels

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_batch(self, prompts: Sequence[Sequence[int]]) -> torch.Tensor:
        # left-pad to align last positions (prefill logits are last-token)
        L = max(len(p) for p in prompts)
        arr = np.zeros((len(prompts), L), np.int32)
        for i, p in enumerate(prompts):
            arr[i, L - len(p):] = np.asarray(p, np.int32)
        return torch.from_numpy(arr).to(self.device)

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 32) -> GenerationResult:
        tokens = self._pad_batch(prompts)
        t0 = time.perf_counter()
        logits, cache = forward_prefill(self.params, self.cfg, tokens,
                                        cache_window=self.cache_window,
                                        use_kernels=self.use_kernels)
        self._sync()
        t_prefill = time.perf_counter() - t0

        out: List[List[int]] = [[] for _ in prompts]
        tok = torch.argmax(logits, -1).to(torch.int32)
        t1 = time.perf_counter()
        for _ in range(max_new_tokens):
            for i, t in enumerate(tok.tolist()):
                out[i].append(t)
            logits, cache = forward_decode(self.params, self.cfg, tok, cache,
                                           use_kernels=self.use_kernels)
            tok = torch.argmax(logits, -1).to(torch.int32)
        self._sync()
        t_decode = time.perf_counter() - t1
        tps = len(prompts) * max_new_tokens / max(t_decode, 1e-9)
        return GenerationResult(out, t_prefill, t_decode, tps)
