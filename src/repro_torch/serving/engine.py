"""Serving engine of the port: batched prefill + greedy decode.

Port of ``repro/serving/engine.py``. Prompts are left-padded into one
batch (pads are token 0 and are not masked, positions start at 0: the
reference's behaviour, kept; an ssm or hybrid model pads to a multiple
of its SSD chunk), the cache is prefilled, then each step decodes one
token per sequence greedily. Attention, the SSD scan and the MoE expert
products run through the hand-written CUDA kernels (``use_kernels``, on
by default) when the engine's device is CUDA. ``cache_window`` sizes the
ring KV caches: one per layer of a dense or moe model, one per
application of the hybrid's shared attention block
(``kv_cache.num_attn_layers``); an ssm model keeps none and ignores it.
A vlm model prefills its ``patch_embeds`` (zeros when the caller gives
none, as the reference's engine does) before the padded prompts, so the
pads sit between the patches and the text. An audio model (whisper)
encodes the caller's ``frame_embeds`` (B, encoder_seq, d_model), zeros
when none are given, as the reference's engine does. On CUDA a model
whose weights alone exceed the card's memory is refused before anything
is allocated.

Spans (:mod:`repro_torch.tracing`, recorded only when enabled) wrap the
timed statements: ``engine.generate`` over a call; ``engine.prefill.launch``
(the forward pass) and ``engine.prefill.wait`` (its synchronise); for each
decode step ``engine.decode.wait`` (``tok.tolist()``: the host waits for
the token of step ``step``, -1 being the prefill's) and
``engine.decode.launch`` (the step's forward pass and argmax, ``read``
false on the last step, whose token is dropped); the closing synchronise
is the last step's wait.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs import one_chip_ids
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (
    count_params_analytic,
    forward_decode,
    forward_prefill,
    init_params,
)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[List[int]]
    prefill_s: float
    decode_s: float
    tokens_per_s: float


def _check_fits(cfg: ModelConfig, device: torch.device) -> None:
    """Raise if the model's weights alone exceed the card's memory."""
    need = count_params_analytic(cfg) * cfg.torch_dtype.itemsize
    have = torch.cuda.get_device_properties(device).total_memory
    if need > have:
        cuts = one_chip_ids(cfg.name)
        hint = f"; serve {' or '.join(cuts)} instead" if cuts else ""
        raise ValueError(f"{cfg.name}: {need / 1e9:.1f} GB of {cfg.dtype} weights exceed "
                         f"the card's {have / 1e9:.1f} GB{hint}")


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, *, cache_window: int = 256,
                 seed: int = 0, use_kernels: bool = True, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            if self.device.type == "cuda":
                _check_fits(cfg, self.device)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(gen, cfg)
        self.params = params
        self.cache_window = cache_window
        self.use_kernels = use_kernels

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad_batch(self, prompts: Sequence[Sequence[int]]) -> torch.Tensor:
        # left-pad to align last positions (prefill logits are last-token);
        # the SSD scan takes whole chunks, so ssm rows pad to a multiple
        L = max(len(p) for p in prompts)
        if self.cfg.family in ("ssm", "hybrid"):
            L = -(-L // self.cfg.ssm_chunk) * self.cfg.ssm_chunk
        arr = np.zeros((len(prompts), L), np.int32)
        for i, p in enumerate(prompts):
            arr[i, L - len(p):] = np.asarray(p, np.int32)
        return torch.from_numpy(arr).to(self.device)

    @torch.inference_mode()
    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int = 32,
                 frame_embeds: Optional[torch.Tensor] = None,
                 patch_embeds: Optional[torch.Tensor] = None) -> GenerationResult:
        cfg = self.cfg
        with tracing.span("engine.generate", batch=len(prompts),
                          max_new=max_new_tokens) as call:
            tokens = self._pad_batch(prompts)
            call.set(padded=tokens.shape[1])

            def zeros(n):
                return torch.zeros((tokens.shape[0], n, cfg.d_model), dtype=cfg.torch_dtype,
                                   device=self.device)

            if cfg.is_encoder_decoder and frame_embeds is None:
                frame_embeds = zeros(cfg.encoder_seq)
            if cfg.family == "vlm" and patch_embeds is None:
                patch_embeds = zeros(cfg.frontend_tokens)
            t0 = time.perf_counter()
            with tracing.span("engine.prefill.launch"):
                logits, cache = forward_prefill(self.params, cfg, tokens,
                                                patch_embeds=patch_embeds,
                                                frame_embeds=frame_embeds,
                                                cache_window=self.cache_window,
                                                use_kernels=self.use_kernels)
            with tracing.span("engine.prefill.wait"):
                self._sync()
            t_prefill = time.perf_counter() - t0

            out: List[List[int]] = [[] for _ in prompts]
            tok = torch.argmax(logits, -1).to(torch.int32)
            # every step's token is read at the next step's wait; the last
            # step's token never is (the first token came from the prefill)
            t1 = time.perf_counter()
            for step in range(max_new_tokens):
                with tracing.span("engine.decode.wait", step=step - 1):
                    toks = tok.tolist()
                for i, t in enumerate(toks):
                    out[i].append(t)
                with tracing.span("engine.decode.launch", step=step,
                                  read=step < max_new_tokens - 1):
                    logits, cache = forward_decode(self.params, cfg, tok, cache,
                                                   use_kernels=self.use_kernels)
                    tok = torch.argmax(logits, -1).to(torch.int32)
            with tracing.span("engine.decode.wait", step=max_new_tokens - 1):
                self._sync()
            t_decode = time.perf_counter() - t1
        tps = len(prompts) * max_new_tokens / max(t_decode, 1e-9)
        return GenerationResult(out, t_prefill, t_decode, tps)
