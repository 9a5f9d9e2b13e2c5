"""Serving engine of the port: batched prefill + greedy decode.

Port of ``repro/serving/engine.py``. Prompts are left-padded into one
batch (pads are token 0 and are not masked, positions start at 0: the
reference's behaviour, kept; every family pads to the longest prompt
alone, the SSD scan padding its own tail exactly: ``kernels/ops.py``),
the cache is prefilled, then each step decodes one
token per sequence greedily. Attention, the SSD scan and the MoE expert
products run through the hand-written CUDA kernels (``use_kernels``, on
by default) when the engine's device is CUDA. ``cache_window`` sizes the
ring KV caches: one per layer of a dense or moe model, one per
application of the hybrid's shared attention block, one per attention
layer of the hybrid_moe (``kv_cache.num_attn_layers``); an ssm model
keeps none and ignores it.
A vlm model prefills its ``patch_embeds`` (zeros when the caller gives
none, as the reference's engine does) before the padded prompts, so the
pads sit between the patches and the text. An audio model (whisper)
encodes the caller's ``frame_embeds`` (B, encoder_seq, d_model), zeros
when none are given, as the reference's engine does. On CUDA a model
whose weights alone exceed the card's memory is refused before anything
is allocated.

On CUDA each decode step is a CUDA graph replay (:class:`DecodeGraph`).
The engine keeps one graph per cache shape (:func:`cache_key`: each cache
tensor's name, shape and dtype; for a dense model batch B at the engine's
window), with buffers of its own for the token and the cache, all graphs
sharing one memory pool. A call copies its prefill's token and cache into
the buffers (one copy a tensor) and replays the step once a token. The
first step of a new shape runs eagerly on a side stream, as PyTorch's
warm-up, and is then recorded. Nothing else changes: the same model code,
the same hand-written kernels, the same operations; only the host
launches them once a step instead of one by one. CPU tensors keep the
eager loop. A capture that fails raises.

Spans (:mod:`repro_torch.tracing`, recorded only when enabled) wrap the
timed statements: ``engine.generate`` over a call; ``engine.prefill.launch``
(the forward pass) and ``engine.prefill.wait`` (its synchronise); for each
decode step ``engine.decode.wait`` (``tok.tolist()``: the host waits for
the token of step ``step``, -1 being the prefill's) and
``engine.decode.launch`` (the step's forward pass and argmax, ``read``
false on the last step, whose token is dropped, ``graph`` true on a
replay; step 0's also holds the copy into the graph's buffers);
``engine.decode.capture`` (batch, window) around a new shape's warm-up
step and recording, inside that step's launch; the closing synchronise
is the last step's wait.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


CacheKey = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def cache_key(cache: Dict[str, torch.Tensor]) -> CacheKey:
    """The shape a decode graph is recorded for: each cache tensor's name,
    shape and dtype."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(cache.items()))


class DecodeGraph:
    """One cache shape's decode step, on buffers of its own.

    :meth:`load` copies a prefill's token and cache into the buffers, one
    copy a tensor. :meth:`step` is the engine's decode step written back
    into them: ``forward_decode`` on ``tok`` and ``cache``, the greedy
    token into ``tok``, the new positions into ``cache["pos"]`` (which
    ``forward_decode`` rebinds; the buffer is put back), the step's
    logits left in ``logits``. On CUDA :meth:`capture` runs one step on a
    side stream (the shape's first real step, PyTorch's warm-up), then
    records the step without running it, and :meth:`replay` launches the
    recorded step.

    The kernel wrappers count their launches on the host, so recording a
    step counts launches that never ran: :meth:`capture` takes those
    counts back and :meth:`replay` adds them once a replay, and
    ``ops.launch_counts()`` reads what the eager loop would. The buffers
    live outside the pool the graphs share, so no graph reads what
    another wrote and the graphs may replay in any order. A recorded step
    reads the weights where they lay when it was recorded.
    """

    def __init__(self, params, cfg: ModelConfig, use_kernels: bool, tok: torch.Tensor,
                 cache: Dict[str, torch.Tensor]):
        self.params, self.cfg, self.use_kernels = params, cfg, use_kernels
        self.tok = torch.empty_like(tok)
        self.cache = {k: torch.empty_like(v) for k, v in cache.items()}
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}

    def load(self, tok: torch.Tensor, cache: Dict[str, torch.Tensor]) -> None:
        self.tok.copy_(tok)
        for k, v in cache.items():
            self.cache[k].copy_(v)

    def step(self) -> None:
        pos = self.cache["pos"]
        self.logits, _ = forward_decode(self.params, self.cfg, self.tok, self.cache,
                                        use_kernels=self.use_kernels)
        pos.copy_(self.cache["pos"])
        self.cache["pos"] = pos
        self.tok.copy_(torch.argmax(self.logits, -1))

    def capture(self, pool) -> None:
        device = self.tok.device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step()
        main.wait_stream(side)
        before = tracing.counters()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            self.step()
        after = tracing.counters()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            tracing.count(k, -n)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            tracing.count(k, n)


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
        self.graphs: Dict[CacheKey, DecodeGraph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None

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
            graph = None
            if self.device.type == "cuda":
                key = cache_key(cache)
                if key not in self.graphs:
                    self.graphs[key] = DecodeGraph(self.params, cfg, self.use_kernels, tok, cache)
                graph = self.graphs[key]
            # every step's token is read at the next step's wait; the last
            # step's token never is (the first token came from the prefill)
            t1 = time.perf_counter()
            for step in range(max_new_tokens):
                with tracing.span("engine.decode.wait", step=step - 1):
                    toks = tok.tolist()
                for i, t in enumerate(toks):
                    out[i].append(t)
                replay = graph is not None and graph.graph is not None
                with tracing.span("engine.decode.launch", step=step,
                                  read=step < max_new_tokens - 1, graph=replay):
                    if graph is None:
                        logits, cache = forward_decode(self.params, cfg, tok, cache,
                                                       use_kernels=self.use_kernels)
                        tok = torch.argmax(logits, -1).to(torch.int32)
                    else:
                        if step == 0:
                            graph.load(tok, cache)
                            tok = graph.tok
                        if replay:
                            graph.replay()
                        else:
                            window = cache["k"].shape[2] if "k" in cache else None
                            with tracing.span("engine.decode.capture", batch=len(prompts),
                                              window=window):
                                graph.capture(self._pool)
            with tracing.span("engine.decode.wait", step=max_new_tokens - 1):
                self._sync()
            t_decode = time.perf_counter() - t1
        tps = len(prompts) * max_new_tokens / max(t_decode, 1e-9)
        return GenerationResult(out, t_prefill, t_decode, tps)
