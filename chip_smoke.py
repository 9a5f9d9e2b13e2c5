#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for an H100: the kernels compile for sm_90a). Phases, each of which
passes or ends the run with a non-zero exit:

1. device   -- torch / CUDA versions, the card's name and power limit from
               nvidia-smi; TF32 off so float32 runs in float32.
2. build    -- both CUDA kernels compiled from src/repro_torch/kernels/csrc
               with nvcc (one process per source, started together).
3. kernels  -- each kernel against its plain PyTorch version on the card
               over a grid of shapes and edges (bf16 and f32, S and W off
               the tile size, windows, non-causal, a fully masked row, the
               W+1 self slot), within tests/test_kernels.py's TOL; at the
               serving path's shapes also the kernel, plain and
               scaled_dot_product_attention times and the roofline bound.
4. reduced  -- reduced qwen2.5-3b, prefill + 8 teacher-forced decode steps,
               logits on the card (kernels) against the same code on the
               CPU (plain), within 0.02 relative; window 128 and 16 (wrap).
5. serve    -- full-width qwen2.5-3b (random weights from seed 0) through
               launch/serve.py's loop: 6 requests featurized, sized by the
               allocator, generated, fed back. Launch counts must equal
               36 x prefills (flash) and 36 x 16 x requests (decode); the
               full model's kernel path is held against its plain path.
6. profile  -- torch.profiler over one request: top device kernels and the
               device-busy share of the wall clock.

The line before the last is the JSON kernel record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MEM_BPS = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; fp32 CUDA cores
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels.py:19, x max(|ref|, 1)
REDUCED_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
FULL_F32_REL = 1e-3  # full width, float32 both sides: summation order only
SERVE_REQUESTS, SERVE_MAX_NEW = 6, 16
CALL_MS = {}  # back-to-back wrapper call time (Python included) at the path's shapes


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- timing
def time_ms(torch, fn, iters: int = 50, warmup: int = 10, queued: bool = True) -> float:
    """Time per call from CUDA events around ``iters`` calls. With
    ``queued`` a spin kernel holds the stream first, so the host queues
    every call before the start event runs and the events time the device
    work alone; without it they time back-to-back calls, Python included
    (at these shapes the Python call takes longer than the kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)  # ~0.1 s at 2 GHz, longer than queuing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int, dtype: str):
    """Least time on the card (ms) and what sets it."""
    t_bytes, t_ops = nbytes / MEM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, ref):
    err = float((got.float() - ref.float()).abs().max())
    scale = max(float(ref.float().abs().max()) + 1e-6, 1.0)
    return err, scale


# ----------------------------------------------------------- phase 3: kernels
def flash_inputs(torch, B, S, H, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def decode_inputs(torch, B, W, H, Hkv, D, dtype, pos, seed):
    """Inputs built as the model's decode step builds them: a ring of W-1
    slots after ``pos`` writes, plus the current token's self slot."""
    from repro_torch.models.kv_cache import ring_positions, ring_valid

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
               for shape in ((B, 1, H, D), (B, W, Hkv, D), (B, W, Hkv, D)))
    q_pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kv_pos = torch.cat([ring_positions(q_pos, W - 1), q_pos[:, None]], dim=1).contiguous()
    valid = torch.cat([ring_valid(q_pos, W - 1),
                       torch.ones((B, 1), dtype=torch.bool, device="cuda")], dim=1).contiguous()
    return q, k, v, kv_pos, valid, q_pos


def flash_case(torch, F, fa, ref, B, S, Hkv, G, D, dt, causal, window, timed=False):
    dtype = getattr(torch, dt)
    H = Hkv * G
    q, k, v = flash_inputs(torch, B, S, H, Hkv, D, dtype, seed=B * 7919 + S * 31 + H + D)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    if not (got.shape == want.shape and got.dtype == q.dtype and err <= TOL[dt] * scale):
        raise AssertionError(f"flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} {dt} "
                             f"causal={causal} window={window}: err {err} > {TOL[dt] * scale}")
    if not timed:
        return err, None
    qpos = torch.arange(S, device="cuda")[:, None]
    kpos = torch.arange(S, device="cuda")[None, :]
    live = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    flops = 4 * B * H * D * int(live.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, flops, dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    plain_causal = causal and window is None
    mask = None if plain_causal else live

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=plain_causal, enable_gqa=True)

    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window)),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                                   window=window)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(torch, lib),  # yardstick only: the port never calls it
    }
    CALL_MS[("flash", B, S)] = time_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window), queued=False)
    return err, rec


def decode_case(torch, F, da, ref, B, W, Hkv, G, D, dt, pos, timed=False, dead_row=False):
    dtype = getattr(torch, dt)
    H = Hkv * G
    q, k, v, kv_pos, valid, q_pos = decode_inputs(torch, B, W, H, Hkv, D, dtype, pos,
                                                  seed=B * 104729 + W * 17 + H + D)
    if dead_row:
        valid[0] = False
    got = da.decode_attention(q, k, v, kv_pos, valid, q_pos)
    want = ref.decode_attention_ref(q, k, v, kv_pos, valid, q_pos)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    if not (got.shape == want.shape and got.dtype == q.dtype and err <= TOL[dt] * scale):
        raise AssertionError(f"decode_attention B={B} W={W} H={H} Hkv={Hkv} D={D} {dt} "
                             f"pos={pos}: err {err} > {TOL[dt] * scale}")
    if dead_row and int(torch.count_nonzero(got[0])) != 0:
        raise AssertionError("decode_attention: a fully masked row is not exactly 0")
    if not timed:
        return err, None
    live = valid & (kv_pos <= q_pos[:, None])
    flops = 4 * Hkv * G * D * int(live.sum())
    nbytes = ((2 * q.numel() + k.numel() + v.numel()) * q.element_size()
              + kv_pos.numel() * 4 + valid.numel() + q_pos.numel() * 4)
    bound_ms, bound_by = bound(nbytes, flops, dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = live[:, None, None, :]
    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: da.decode_attention(q, k, v, kv_pos, valid, q_pos)),
        "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(q, k, v, kv_pos, valid,
                                                                    q_pos)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
    }
    CALL_MS[("decode", B)] = time_ms(
        torch, lambda: da.decode_attention(q, k, v, kv_pos, valid, q_pos), queued=False)
    return err, rec


def fmt(rec):
    return (f"max_abs_err {rec['max_abs_err']:.3g} | kernel (device) {rec['ms']:.4f} ms | "
            f"plain {rec['plain_ms']:.4f} ms | sdpa {rec['library_ms']:.4f} ms | "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")


def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    # the serving path: full qwen2.5-3b (H=16, Hkv=2, D=128, bf16) prefills
    # prompts of 8/24/48 tokens; quickstart-style batches pad to 33
    path_records = {}
    for B, S in ((1, 8), (1, 24), (1, 48), (3, 33)):
        _, rec = flash_case(torch, F, fa, ref, B, S, 2, 8, 128, "bfloat16", True, None,
                            timed=True)
        log("kernels", f"flash_attention B={B} S={S} H=16 Hkv=2 D=128 bf16 causal: {fmt(rec)}"
                       f" | wrapper call {CALL_MS[('flash', B, S)]:.4f} ms")
        path_records[("flash", B, S)] = rec
    worst, n = 0.0, 0
    for dt in ("bfloat16", "float32"):
        for Hkv, G, D in ((2, 8, 128), (2, 2, 64), (1, 4, 64), (4, 1, 128)):
            for S in (8, 33, 48, 96, 200):
                for causal, window in ((True, None), (True, 32), (False, None), (False, 32)):
                    err, _ = flash_case(torch, F, fa, ref, 2 if S < 96 else 1, S, Hkv, G, D,
                                        dt, causal, window)
                    worst, n = max(worst, err), n + 1
    log("kernels", f"flash_attention grid: {n} cases within TOL (max abs err {worst:.3g})")

    # decode: ring window 128 + the self slot = 129 slots; the longest
    # path prompt (48) after 15 decoded tokens sits at position 63
    for B, pos in ((1, [63]), (3, [40, 200, 128])):
        _, rec = decode_case(torch, F, da, ref, B, 129, 2, 8, 128, "bfloat16", pos, timed=True)
        log("kernels", f"decode_attention B={B} W=129 H=16 Hkv=2 D=128 bf16 pos={pos}: "
                       f"{fmt(rec)} | wrapper call {CALL_MS[('decode', B)]:.4f} ms")
        path_records[("decode", B)] = rec
    worst, n = 0.0, 0
    for dt in ("bfloat16", "float32"):
        for Hkv, G, D in ((2, 8, 128), (2, 2, 64), (8, 1, 128), (1, 16, 64)):
            for W in (17, 65, 129, 131):
                for B, pos in ((1, [1]), (2, [W // 2, W - 1]), (3, [W, 2 * W + 5, 5 * W // 2])):
                    err, _ = decode_case(torch, F, da, ref, B, W, Hkv, G, D, dt, pos)
                    worst, n = max(worst, err), n + 1
            decode_case(torch, F, da, ref, 2, 129, Hkv, G, D, dt, [70, 300], dead_row=True)
            n += 1
    log("kernels", f"decode_attention grid: {n} cases within TOL incl. fully masked rows "
                   f"(max abs err {worst:.3g})")
    return path_records[("flash", 1, 48)], path_records[("decode", 1)]


# ---------------------------------------------------- phase 4: reduced parity
def run_teacher_forced(torch, params, cfg, tokens, teacher, window):
    from repro_torch.models.model import forward_decode, forward_prefill

    logits, cache = forward_prefill(params, cfg, tokens, cache_window=window)
    out = [logits.float().cpu()]
    for t in teacher:
        logits, cache = forward_decode(params, cfg, t, cache)
        out.append(logits.float().cpu())
    return out


def phase_reduced(torch):
    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params

    cfg = get_reduced_config("qwen2.5-3b")
    cpu_params = init_params(torch.Generator().manual_seed(0), cfg)

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    gpu_params = to(cpu_params, "cuda")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    teacher = rng.integers(1, cfg.vocab_size, size=(8, 2)).astype(np.int32)
    with torch.inference_mode():
        for window in (128, 16):
            ops.reset_launch_counts()
            got = run_teacher_forced(torch, gpu_params, cfg, torch.from_numpy(toks).cuda(),
                                     [torch.from_numpy(t).cuda() for t in teacher], window)
            counts = ops.launch_counts()
            want = run_teacher_forced(torch, cpu_params, cfg, torch.from_numpy(toks),
                                      [torch.from_numpy(t) for t in teacher], window)
            rel = max(float((a - b).abs().max()) / float(b.abs().max())
                      for a, b in zip(got, want))
            expected = {"flash_attention": cfg.num_layers,
                        "decode_attention": cfg.num_layers * len(teacher)}
            if counts != expected:
                raise AssertionError(f"reduced: launches {counts} != {expected}")
            if not (all(torch.isfinite(a).all() for a in got) and rel < REDUCED_REL):
                raise AssertionError(f"reduced window={window}: rel err {rel} >= {REDUCED_REL}")
            log("reduced", f"{cfg.name} window={window}: prefill + {len(teacher)} "
                           f"teacher-forced decode steps, cuda (kernels) vs cpu (plain) "
                           f"logits max rel err {rel:.4g} (< {REDUCED_REL}); launches {counts}")


# ---------------------------------------------------------- phase 5: serve
def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import count_params

    cfg = get_config("qwen2.5-3b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()  # counts from here on are the main path's
    engine, served = serve(cfg, requests=SERVE_REQUESTS, max_new=SERVE_MAX_NEW, seed=0,
                           device="cuda", log=lambda m: log("serve", m))
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"flash_attention": cfg.num_layers * len(served),
                "decode_attention": cfg.num_layers * SERVE_MAX_NEW * len(served)}
    log("serve", f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                 f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {cfg.head_dim}, "
                 f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
                 f"{count_params(engine.params) / 1e9:.3f} B params (random, seed 0)")
    if counts != expected:
        raise AssertionError(f"serve: launches {counts} != expected {expected}")
    for rec in served:
        toks = rec.result.tokens[0]
        if len(toks) != SERVE_MAX_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"serve: bad tokens {toks}")
    prefill = [r.result.prefill_s * 1e3 for r in served]
    decode = [r.result.decode_s * 1e3 / SERVE_MAX_NEW for r in served]
    log("serve", f"{len(served)} requests in {wall:.2f} s incl. weight init; peak memory "
                 f"{peak_gb:.2f} GB; prefill ms {[round(p, 2) for p in prefill]}; decode "
                 f"ms/step median {statistics.median(decode):.2f} (min {min(decode):.2f}, "
                 f"max {max(decode):.2f}); launches {counts} (expected {expected})")

    # The full-width kernel path against the plain path on the card, on
    # the served weights widened to float32: both paths then differ only
    # in summation order, and FULL_F32_REL leaves room for 36 layers of it.
    # (In bf16 the plain path rounds probabilities to bf16 before P.V and
    # the kernel keeps them in fp32; over 36 layers that alone reaches
    # about 0.02 of the largest logit, so bf16 is no test of the kernels.)
    import dataclasses

    from repro_torch.models.model import forward_decode, forward_prefill

    def widen(tree):
        return {k: widen(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = widen(engine.params)
    prompt = torch.tensor([served[0].prompt], dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        seqs = {}
        for use_kernels in (True, False):
            logits, cache = forward_prefill(params32, cfg32, prompt, cache_window=128,
                                            use_kernels=use_kernels)
            seq = [logits]
            for t in served[0].result.tokens[0][:4]:
                token = torch.tensor([t], dtype=torch.int32, device="cuda")
                logits, cache = forward_decode(params32, cfg32, token, cache,
                                               use_kernels=use_kernels)
                seq.append(logits)
            seqs[use_kernels] = seq
        rels = []
        for a, b in zip(seqs[True], seqs[False]):
            if not (a.shape == (1, cfg.vocab_size) and torch.isfinite(a).all()):
                raise AssertionError("serve: non-finite or misshapen full-width logits")
            rels.append(float((a - b).abs().max()) / float(b.abs().max()))
    del params32
    if max(rels) >= FULL_F32_REL:
        raise AssertionError(f"serve: full-width f32 kernel vs plain rel err {max(rels)}")
    log("serve", f"full width in float32, prefill + 4 decode steps, kernels vs plain on "
                 f"the card: logits max rel err {max(rels):.3g} (< {FULL_F32_REL})")
    return engine, served, counts


# --------------------------------------------------------- phase 6: profile
def phase_profile(torch, engine, prompt):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, cnt = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    busy_ms = sum(t for t, _ in kernels.values())
    launches = sum(c for _, c in kernels.values())
    if busy_ms <= 0:
        raise AssertionError("profile: the trace holds no device time")
    share = busy_ms / wall_ms
    log("profile", f"1 request, prompt {len(prompt)}, {SERVE_MAX_NEW} new tokens: untraced "
                   f"wall {wall_ms:.2f} ms (prefill {res.prefill_s * 1e3:.2f} ms, decode "
                   f"{res.decode_s * 1e3 / SERVE_MAX_NEW:.2f} ms/step); traced device time "
                   f"{busy_ms:.2f} ms = device busy {100 * share:.1f}% of the untraced wall; "
                   f"{launches} device kernels (~{launches / (SERVE_MAX_NEW + 1):.0f} per "
                   f"forward pass)")
    for name, (t, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log("profile", f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{cnt:<5d} {name[:90]}")
    log("profile", "nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
                   + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 2

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = nvidia_smi("name,power.limit")
    log("device", f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | count "
                  f"{torch.cuda.device_count()}")
    log("device", "TF32 off for matmul and cuDNN (float32 runs in float32)")
    print(name_power, flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    log("build", f"{', '.join(_build.KERNELS)} built from {_build.CSRC.relative_to(ROOT)} "
                 f"in {time.perf_counter() - t0:.1f} s")
    for kname, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"  {kname}: {line.strip()}")

    # 3-6
    flash_rec, decode_rec = phase_kernels(torch)
    phase_reduced(torch)
    engine, served, counts = phase_serve(torch)
    phase_profile(torch, engine, served[0].prompt)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:103",
         "launches": counts["flash_attention"], **flash_rec},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:80",
         "launches": counts["decode_attention"], **decode_rec},
    ]
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s on {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
