"""Quickstart on the PyTorch port: serve a model through Shabari.

The port of ``examples/quickstart.py``, with the same printed lines:
  1. a REAL reduced qwen-family model generates tokens via the port's
     serving engine (batched prefill + ring-cache decode; on a card its
     attention runs the hand-written CUDA kernels);
  2. a stream of differently-sized requests flows through Shabari's
     featurizer -> online allocator -> feedback loop, showing the
     per-invocation right-sizing the paper is about.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(the card by default).
"""

import argparse

import numpy as np

from repro_torch.configs import get_reduced_config
from repro_torch.core import Featurizer, Observation, ResourceAllocator
from repro_torch.serving.engine import ServingEngine


def serve_cost(vcpus: int, prompt_len: int) -> float:
    # longer prompts need more parallel slices to hit the latency SLO
    work = 0.004 * prompt_len
    return 0.05 + work / min(vcpus, max(prompt_len // 16, 1))


def request(prompt_tokens: int) -> dict:
    return {"prompt_tokens": prompt_tokens, "batch": 1, "max_new_tokens": 16,
            "image_tiles": 0, "audio_seconds": 0}


def main(device: str = "cuda") -> None:
    # ---------------------------------------------------- 1. real model
    cfg = get_reduced_config("qwen2.5-3b")
    engine = ServingEngine(cfg, cache_window=128, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=n))
               for n in (8, 19, 33)]
    res = engine.generate(prompts, max_new_tokens=16)
    print(f"[engine] generated {len(res.tokens)}x16 tokens | "
          f"prefill {res.prefill_s*1e3:.1f} ms | "
          f"decode {res.decode_s*1e3:.1f} ms | {res.tokens_per_s:,.0f} tok/s")
    print(f"[engine] first continuation: {res.tokens[0][:8]} ...")

    # ------------------------------------- 2. Shabari sizing a workload
    feat = Featurizer()
    alloc = ResourceAllocator(device=device)
    slo = 0.25
    print("\n[shabari] learning request-size -> slice-count mapping (SLO 250 ms)")
    for _ in range(120):
        n = int(rng.choice([16, 64, 256]))
        x = feat.extract("serve-qwen", "request", request(n))
        a = alloc.allocate("serve-qwen", x)
        t = serve_cost(a.vcpus, n)
        used = min(a.vcpus, max(n // 16, 1))
        alloc.feedback("serve-qwen", x, Observation(
            exec_time_s=t, slo_s=slo, alloc_vcpus=a.vcpus,
            max_vcpus_used=used, alloc_mem_mb=a.mem_mb,
            max_mem_used_mb=32 + 0.5 * n))
    for n in (16, 64, 256):
        x = feat.extract("serve-qwen", "request", request(n))
        a = alloc.allocate("serve-qwen", x)
        t = serve_cost(a.vcpus, n)
        print(f"  prompt={n:4d} tokens -> slices={a.vcpus:2d} "
              f"mem={a.mem_mb:4d}MB  latency={t*1e3:5.1f} ms "
              f"({'meets' if t <= slo else 'MISSES'} SLO)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda by default; cpu for a CPU run)")
    main(ap.parse_args().device)
