"""Serving launcher: requests through Shabari's loop on the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
      [--requests 6] [--max-new 16] [--seed 0] [--reduced] [--device cpu] \
      [--trace spans.json]

``--arch`` takes qwen2.5-3b, nemotron-4-15b (squared-ReLU MLP),
codeqwen1.5-7b and phi3-mini-3.8b (dense), internvl2-76b-40l (vlm: 256
patch embeddings, zeros here, before the prompt; 40 of 80 layers),
mamba2-1.3b (ssm), zamba2-7b (hybrid: 81 Mamba2 layers and a shared
attention block), whisper-tiny (audio: a 4-layer encoder over 1500
frame embeddings, zeros here, and a 4-layer decoder that cross-attends
to them), mixtral-8x7b-16l (moe, 16 of 32 layers) and
granite-4.0-h-small (hybrid_moe: 36 Mamba2 and 4 attention layers, each
followed by 72 top-10 experts and a shared expert; 64.4 GB); with
``--reduced`` also mixtral-8x7b, internvl2-76b and arctic-480b. The
published mixtral-8x7b and internvl2-76b do not fit one card and are
refused before anything is allocated.

Each request is featurized, sized by the online allocator (vCPU slices
and memory), executed by the serving engine, and fed back to the agents
as an observation, as in ``repro/launch/serve.py``. By default it serves
the FULL published config on CUDA with random weights made from
``--seed``; ``--reduced`` and ``--device cpu`` are for the tests.

``--trace PATH`` records the program's spans (:mod:`repro_torch.tracing`;
each request under an ``invocation`` span) and writes them with the
counters to PATH as Chrome trace events, which Perfetto opens beside a
``torch.profiler`` export.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import Allocation, Featurizer, Observation, ResourceAllocator
from repro_torch.serving.engine import GenerationResult, ServingEngine

CACHE_WINDOW = 128


@dataclasses.dataclass
class ServedRequest:
    prompt: List[int]
    allocation: Allocation
    result: GenerationResult

    @property
    def latency_s(self) -> float:
        return self.result.prefill_s + self.result.decode_s


def serve(cfg: ModelConfig, *, requests: int = 6, max_new: int = 16,
          slo_ms: float = 500.0, seed: int = 0, device="cuda",
          log=print) -> Tuple[ServingEngine, List[ServedRequest]]:
    """Serve ``requests`` single-prompt requests through featurize ->
    allocate -> generate -> feedback. Returns the engine and a record per
    request."""
    engine = ServingEngine(cfg, cache_window=CACHE_WINDOW, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    feat = Featurizer()
    alloc = ResourceAllocator(vcpu_confidence=2, mem_confidence=4, device=device)
    slo = slo_ms / 1e3
    served: List[ServedRequest] = []
    for i in range(requests):
        n = int(rng.choice([8, 24, 48]))
        prompt = [int(t) for t in rng.integers(1, cfg.vocab_size, size=n)]
        with tracing.span("invocation", invocation=i):
            x = feat.extract(cfg.name, "request", {
                "prompt_tokens": n, "batch": 1, "max_new_tokens": max_new,
                "image_tiles": 0, "audio_seconds": 0,
            })
            a = alloc.allocate(cfg.name, x)
            res = engine.generate([prompt], max_new_tokens=max_new)
            rec = ServedRequest(prompt, a, res)
            alloc.feedback(cfg.name, x, Observation(
                exec_time_s=rec.latency_s, slo_s=slo, alloc_vcpus=a.vcpus,
                max_vcpus_used=min(a.vcpus, max(n // 16, 1)),
                alloc_mem_mb=a.mem_mb, max_mem_used_mb=64 + 0.5 * n,
            ))
        served.append(rec)
        log(f"req {i}: prompt={n:3d} -> slices={a.vcpus:2d} mem={a.mem_mb:4d}MB "
            f"prefill={res.prefill_s * 1e3:7.2f}ms "
            f"decode={res.decode_s * 1e3 / max(max_new, 1):6.2f}ms/step "
            f"latency={rec.latency_s * 1e3:7.1f}ms ({res.tokens_per_s:,.0f} tok/s) "
            f"{'OK' if rec.latency_s <= slo else 'SLO-MISS'}")
    return engine, served


def main(argv: Optional[Sequence[str]] = None) -> List[ServedRequest]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slo-ms", type=float, default=500.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reduced variant of the architecture")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH",
                    help="write the spans and counters to PATH (Chrome trace events)")
    args = ap.parse_args(argv)

    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    print(f"serving {cfg.name} ({'reduced' if args.reduced else 'full'}, "
          f"{cfg.family}, {cfg.dtype}) on {args.device}")
    if args.trace:
        tracing.enable()
    _, served = serve(cfg, requests=args.requests, max_new=args.max_new,
                      slo_ms=args.slo_ms, seed=args.seed, device=args.device)
    if args.trace:
        tracing.disable()
        spans = tracing.drain()
        tracing.write_chrome_trace(args.trace, spans, tracing.counters())
        print(f"{len(spans)} spans and the counters written to {args.trace}")
    return served


if __name__ == "__main__":
    main()
