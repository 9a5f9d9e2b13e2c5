#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for an H100: the kernels compile for sm_90a). Phases, each of which
passes or ends the run with a non-zero exit:

1. device   -- torch / CUDA versions, the card's name and power limit from
               nvidia-smi; TF32 off so float32 runs in float32.
2. build    -- the four CUDA kernel libraries compiled from src/repro_torch/kernels/csrc
               with nvcc (one process per source, started together); each
               instantiation's registers and spills; from cuobjdump -sass,
               the tensor-core products of the bf16 bodies of flash, the SSD
               scan and the MoE matmul (HMMA: it fails without them; flash
               also needs LDSM, the others log it; the warpgroup bodies of
               flash (past 512 packed rows) and of the grouped MoE product
               must exist and issue HGMMA) and the decode kernel's
               cluster barrier; the decode launch's cluster size at several W.
3. kernels  -- each kernel against its plain PyTorch version on the card
               over a grid of shapes and edges. Attention (bf16 and f32, head
               dims 64/96/112/128, groups 1-16, S up to 2048 and W up to 4097,
               S and W off the tile size, windows, non-causal, a fully masked
               row that must be exactly 0, a cluster block with no live slot,
               the W+1 self slot, mixtral's prefill and decode shapes,
               zamba2's (H=Hkv=32, D=112; S 8/48/256/512, W 129 full and
               half full), nemotron's (H=48, Hkv=8: G=6, whose packed rows cross
               the warp's 16-row and the block's 64-row tiles at S=3 and
               S=11), codeqwen's and phi3's (H=Hkv=32, D=128 and 96),
               internvl2's (H=64, Hkv=8, S=256+prompt: 264-304) and
               whisper-tiny's (H=Hkv=6, D=64: the decoder's causal prefill
               and 129-slot ring, the encoder's non-causal S=1500, and the
               decode step's cross-attention over 1500 frames, all live))
               within
               tests/test_kernels.py's TOL; in bf16 also row by row (each
               output row within TOL x max(|its ref row|, 2^-6)). The SSD
               scan (B 1-2, 1-4 chunks of Q 32/64/256, H 2-112 (odd too;
               zamba2's H=112, N=64 at one and two chunks), P 32/64, N
               32/64/128, with and without an initial state, f32
               and bf16) against both the chunked form and the step-by-step
               recurrence (f32: tests/test_kernels.py's absolute bars up to
               Q=64, scaled by max(|ref|, 1) at Q=256; bf16 within TOL and
               row by row; each case logs the kernel's and the chunked form's
               distance from the recurrence). The MoE grouped matmul (E
               1/2/8, C 8/13/16/100, D 64/130/4096, F 72/4096/14336, every
               other case on a strided scatter-buffer view, f32 and bf16)
               within TOL, bf16 row by row; and with experts that hold no
               token (all dead, one live, live experts with only some rows
               filled), whose output rows must be exactly 0; at
               granite-4.0-h-small's decode shapes (E=72, C=8, gate / up
               D=4096 F=768 and down D=768 F=4096, 10 and 50 experts
               live) in f32 and bf16, with times.
               At the serving paths' shapes also the kernel and plain times,
               the library call's time where one exists, and the bound; the
               same for attention at a long shape (flash S=2048, decode
               W=4097 at mixtral's widths) and for the three kernels at
               zamba2's served shapes (flash S=48, decode W=129 at
               position 63, SSD scan H=112 N=64 over its one padded
               chunk) and for attention at the shapes of nemotron,
               codeqwen, phi3 and internvl2 (flash at their longest
               prefill, decode at their last step) and at whisper-tiny's
               four (flash causal S=48 and non-causal S=1500, decode W=129
               and the cross W=1500), on lines of their own; each flash
               line names the body it ran (mma.sync up to 512 packed rows of
               a kv head, wgmma above). The MoE
               matmul's record is the served decode step's: 2 of 8 experts
               hold 1 row each, the bound counts the live experts' weights.
               The grouped (ragged) MoE product of the dropless dispatch at
               mixtral's widths over rows sorted by expert (R = 2, 16, 2,048
               and 16,384 at gate / up, 16,384 at down; each token to 2 of 8
               experts drawn uniformly) and at granite-4.0-h-small's (72
               experts, top-10; R = 2,560, 20,480 and 81,920 at gate / up
               D=4096 F=768 and down D=768 F=4096) within TOL and row by
               row, with its kernel, bound, plain and torch._grouped_mm
               times (its record is mixtral's R = 16,384 gate / up); then
               one mixtral layer's experts over 8,192 tokens, capacity 1.25
               against dropless in turns:
               the dropless products must not be the slower.
4. reduced  -- reduced qwen2.5-3b (window 128 and 16, which wraps), reduced
               mamba2-1.3b (two chunks) and reduced zamba2-7b (two chunks,
               windows 128 and 16), prefill + 8 teacher-forced decode steps,
               logits on the card (kernels) against the same code on the CPU
               (plain), within 0.02 relative, and the same for reduced
               nemotron-4-15b, codeqwen1.5-7b, phi3-mini-3.8b and
               internvl2-76b (behind 16 random patch embeddings) at windows
               128 and 16; reduced mixtral-8x7b and arctic-480b the same in
               float32, within TOL and with every layer's expert ids equal;
               reduced whisper-tiny (random frame embeddings into its
               encoder) the same in float32 within TOL, its bf16 gap printed
               beside it (bf16 rounding alone reaches 0.02 there).
5. quickstart -- examples/quickstart_torch.py on the card and on the CPU: the
               three allocations it prints after its 120-request stream must
               be equal (the CSOAA agents decide alike on both devices).
6. serve    -- each served path at full width (random weights from seed 0)
               through launch/serve.py's loop: 6 requests featurized, sized by
               the allocator, generated, fed back. Launch counts must equal
               the config's arithmetic (qwen2.5-3b: 36 x prefills flash,
               36 x 16 x requests decode; mamba2-1.3b: 48 x prefills SSD scan;
               zamba2-7b, 81 Mamba2 layers and a shared attention block at
               ceil(81/6) = 14 of them: 81 x prefills SSD scan, 14 x prefills
               flash, 14 x 16 x requests decode; mixtral-8x7b-16l, the
               published widths at 16 of 32 layers, dropless (as the
               published block routes): 16 x prefills flash, 16 x 16 x
               requests decode, 3 x 16 grouped MoE products a prefill of
               more than 8 tokens and 3 x 16 per-expert ones every other
               forward pass; nemotron-4-15b, codeqwen1.5-7b and phi3-mini-3.8b,
               32 layers each: 32 x prefills flash, 32 x 16 x requests
               decode; internvl2-76b-40l, the published widths at 40 of 80
               layers behind 256 zero patch embeddings: 40 x prefills flash,
               40 x 16 x requests decode; whisper-tiny, 4 encoder and 4
               decoder layers behind 1500 zero frame embeddings: 8 x
               prefills flash (the decoder causal, the encoder not),
               2 x 4 x 16 x requests decode (the ring and the
               cross-attention over the 1500 frames); every other kernel 0). The
               published internvl2-76b is refused before anything is
               allocated (device memory unchanged). After its profile, each
               full model's kernel path is held against its plain path in
               float32, its weights widened in place after the layers past
               the cut are freed, the peak kept under 90% of the card
               (mixtral: its first 2 layers, expert ids equal; internvl2:
               16 of its 40 layers, random patch embeddings; every other
               model all its layers; whisper-tiny behind random frame
               embeddings).
7. profile  -- torch.profiler over one request of each path: top device
               kernels and the device-busy share of the wall clock; for
               mamba2 and zamba2 also the decode step's plain SSD and conv
               steps; for the dense and vlm models the decode step's weight
               bound (every weight but the embedding table, and the live
               ring slots' K/V); for whisper-tiny the decode step's bound
               (the decoder's weights but the cross K/V projections, the
               lm_head, the live ring slots' K/V and the 1500 cached frames'
               cross K/V; not the encoder); for zamba2 the decode step's weight bound
               (the shared block once per application); for mixtral the MoE
               matmul's share of device time and the decode step's weight bound
               (non-expert weights once, plus the experts_per_token of
               num_experts experts each layer reads).
8. shapes   -- the reference's four assigned shapes (src/repro_torch/configs/base.py
               SHAPES) at qwen2.5-3b's published width and depth, through
               src/repro_torch/launch/{steps,dryrun}.py with random weights
               from seed 0; the one-card cut is the batch alone
               (prefill_32k B=1 of 32, decode_32k B=32 of 128, long_500k
               B=1 and its long-context prefill of 16384 tokens into the
               8192-slot window, train_4k B=1 of 256). First the attention
               kernels at those lengths against their plain versions (flash
               at S=32768 causal and S=16384 with window 8192, the plain
               version over 1024-row query tiles; decode at W=32769 for 32
               sequences and W=8193 at position 524287; bf16 within TOL and
               row by row; kernel, plain, sdpa and bound times); then the
               kernel path against the plain path in float32 at 2 of the 36
               layers (a decode_32k step over a seeded cache; a
               long-context prefill and 4 decode steps) within 1e-3; then
               per shape the dry run's one-card plan against the measured
               memory_allocated (within 2%), the peak, step ms (median of
               2-3 timed steps after a warm-up), tokens/s, the roofline of
               the step as it runs beside it, and the launches (36 flash a
               prefill, 36 decode a step, none in training).
9. train    -- the port's training path (src/repro_torch/training; the plain
               path, as the reference trains, so no kernel is launched: the
               launch counts are the same before and after the phase).
               Reduced qwen2.5-3b, mixtral-8x7b and whisper-tiny (random
               frame embeddings) in float32, resumed on the card and on the
               CPU from one step-0 checkpoint for 3 steps: each step's loss
               and grad norm within 1e-5 relative
               (tests/test_torch_training.py's bar), mixtral's expert ids
               equal. launch/train.py at reduced size on the card, 100 steps
               with a checkpoint at 50, and a run resumed from it: the loss
               falls and the two histories are equal from step 50 on.
               Full-width qwen2.5-3b (bf16 params, float32 moments) through
               train() at B=4, S=512 for 5 steps: finite losses, each step's
               time from CUDA events around train_step, tokens/s, the
               loop's wall per step (the host's data pipeline included),
               peak torch.cuda.max_memory_allocated, and the last step under
               the profiler (device kernels, busy share, top kernels).
10. simulator -- Shabari's cluster simulator (src/repro_torch/serving) with the
               shabari policy's CSOAA agents on the card: all 22 committed
               golden snapshots (tests/goldens/, each with its A/B flag)
               reproduced exactly by run_golden(device="cuda"), every agent
               tensor on the card (on a mismatch it prints the first
               allocation that differs from a CPU rerun, with the top-2 cost
               gaps); examples/serve_cluster_torch.py --quick (Figure 8, 6
               policies x 1200 invocations) printing equal lines on the card
               and on the CPU; and one Azure day at benchmarks/sim_bench.py's
               quick tier (azure-24h at 100k invocations per 8640 s, cut to
               60k invocations over 5184 s, 10 clusters x 16 workers, queue
               admission): events/s, the summary's SLO violation and wasted
               vCPUs / memory, host us per allocator call (p50, p99), device
               kernels per invocation and the device-busy share over a
               profiled 2000-invocation prefix; then the same config at 10k
               invocations on the card and on the CPU with equal summaries.

The line before the last is the JSON kernel record (launches summed over
every served path and the shapes phase's timed steps; each path's own
counts are on its serve line); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import io
import json
import math
import os
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
# SSD scan in float32: tests/test_kernels.py:100-107's absolute bars against the
# chunked form and the recurrence, for chunks of up to SSD_ABS_Q tokens (the
# JAX test's range). At Q = 256 the chunked form itself differs from the
# recurrence by more than 1e-4 where |y| is large (a 256-term sum of dt * A
# and 256-term dot products in float32), so there the bars are scaled by
# max(|ref|, 1) as TOL is; each case logs the kernel's and the chunked form's
# distance from the recurrence and that scale. bf16 takes TOL["bfloat16"].
SSD_TOL32 = {"chunked": 1e-4, "sequential": 5e-3}
SSD_ABS_Q = 64
REDUCED_REL = 0.02  # tests/test_kernels.py:145 relative-logit bar
# Reduced whisper is held in float32 (TOL): in bf16 its rounding alone reaches
# REDUCED_REL. On this phase's inputs the reference's two bf16 paths (Pallas
# decoder attention or not) differ by 0.0142 of the largest logit, and the
# port's bf16 path with float32 attention probabilities (as the kernels keep
# them) differs from its plain path by 0.0211, on the CPU
# (tests/test_torch_audio.py); the card's bf16 gap is printed beside the
# float32 check.
WHISPER_BF16 = "bf16 rounding alone reaches 0.02 on this model; held in float32 above"
FULL_F32_REL = 1e-3  # full width, float32 both sides: summation order only
SERVE_REQUESTS, SERVE_MAX_NEW = 6, 16
# the depth of the full-width float32 check where a model is not widened whole
F32_LAYERS = {"mixtral-8x7b-16l": 2, "internvl2-76b-40l": 16}
F32_PEAK = 0.9  # of the card's memory, the float32 check's peak
# served dropless (moe_capacity_factor None), as the published block and the
# benchmark's cell route: prefills take the grouped product, decode steps
# (8 tokens or fewer) the per-expert one
DROPLESS = ("mixtral-8x7b-16l",)
# served without the profile and the float32 check (granite-4.0-h-small: 64.4
# GB of bf16 weights; its float32 check is the benchmark cell's reference)
SERVE_ONLY = ("granite-4.0-h-small",)
CALL_MS = {}  # back-to-back wrapper call time (Python included) at the path's shapes
# bf16 attention is also held to TOL row by row: each output row (one q head
# at one position) against max(|its own ref row|, ROW_FLOOR), so an error in
# rows whose values are small (late rows of a long prefill, averaging
# hundreds of keys) cannot hide under the scale of the largest row.
ROW_FLOOR = 2.0 ** -6
ROW_RATIO = {"flash": 0.0, "decode": 0.0, "ssd_scan": 0.0, "moe_gmm": 0.0,
             "moe_gmm_grouped": 0.0}  # worst, bf16
# attention of nemotron, codeqwen, phi3 and internvl2 at their longest prefill:
# (name, S, Hkv, G, D); internvl2 prefills 256 patch embeddings before the prompt
DENSE_ATTN = (("nemotron", 48, 8, 6, 128), ("codeqwen", 48, 32, 1, 128),
              ("phi3", 48, 32, 1, 96), ("internvl2", 256 + 48, 8, 8, 128))
# whisper-tiny's attention: H = Hkv = 6, D = 64; its encoder attends over
# ENC_SEQ frames, which a decode step's cross-attention reads whole
WHISPER_HKV, WHISPER_D, ENC_SEQ = 6, 64, 1500


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(name: str) -> str:
    """A kernel's C++ name, shortened to its template (falls back to the
    mangled name where c++filt is missing)."""
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=30)
        full = out.stdout.strip() or name
    except OSError:
        return name
    return full.replace("(anonymous namespace)::", "").split("(")[0]


def check_sass(build) -> None:
    """What the compiled kernels run, from cuobjdump -sass of their
    libraries: the bf16 bodies (``*_tc_kernel``) of flash attention, the SSD
    scan and the MoE matmul must issue tensor-core products (HMMA), flash's
    fed by ldmatrix (LDSM; counted for the others); flash attention and the
    MoE matmul must hold a warpgroup-MMA body (``*_wgmma_kernel``), which
    must issue HGMMA (flash's TMA loads, UTMALDG, are counted); the decode
    kernel's cluster barrier instructions (UCGABAR) are counted."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    for kname, ops_ in (("flash_attention", ("HMMA", "LDSM", "HGMMA", "UTMALDG")),
                        ("decode_attention", ("UCGABAR",)),
                        ("ssd_scan", ("HMMA", "LDSM")),
                        ("moe_gmm", ("HMMA", "LDSM", "HGMMA"))):
        out = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(kname))],
                             capture_output=True, text=True, timeout=120, check=True).stdout
        funcs, cur = {}, None
        for line in out.splitlines():
            if "Function :" in line:
                cur = demangle(line.split("Function :")[1].strip())
                funcs[cur] = dict.fromkeys(ops_, 0)
            elif cur is not None:
                for op in ops_:
                    funcs[cur][op] += f" {op}" in line
        for fname, n in funcs.items():
            log("build", f"  {kname} SASS {fname}: " + ", ".join(f"{op} x{c}" for op, c in
                                                              n.items()))
            if "flash_attention_tc_kernel" in fname and not (n["HMMA"] and n["LDSM"]):
                raise AssertionError(f"{fname}: no mma.sync / ldmatrix in its SASS")
            if "_tc_kernel" in fname and not n["HMMA"]:
                raise AssertionError(f"{fname}: no mma.sync in its SASS")
            if "_wgmma_kernel" in fname and not n["HGMMA"]:
                raise AssertionError(f"{fname}: no warpgroup MMA in its SASS")
        if "HMMA" in ops_ and not any("tc_kernel" in f for f in funcs):
            raise AssertionError(f"{kname}: no tensor-core instantiation in the library")
        if "HGMMA" in ops_ and not any("_wgmma_kernel" in f for f in funcs):
            raise AssertionError(f"{kname}: no warpgroup-MMA instantiation in the library")


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


def check_rows(kind, got, want, what):
    """Per-row bar of bf16 attention (see ROW_FLOOR); returns the ratio."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1).clamp_min(ROW_FLOOR)
    ratio = float((err / scale).max())
    if not ratio <= TOL["bfloat16"]:
        raise AssertionError(f"{what}: a row's err is {ratio} x max(|ref row|, {ROW_FLOOR}) "
                             f"> {TOL['bfloat16']}")
    ROW_RATIO[kind] = max(ROW_RATIO[kind], ratio)
    return ratio


# ----------------------------------------------------------- phase 3: kernels
def flash_inputs(torch, B, S, H, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]


def decode_inputs(torch, B, W, H, Hkv, D, dtype, pos, seed, cross=False):
    """Inputs built as the model's decode step builds them: a ring of W-1
    slots after ``pos`` writes, plus the current token's self slot; with
    ``cross``, an audio decoder's cross-attention: W frames, every one
    valid at positions 0..W-1, the query at W-1 (``pos`` unused)."""
    from repro_torch.models.kv_cache import ring_positions, ring_valid

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)
               for shape in ((B, 1, H, D), (B, W, Hkv, D), (B, W, Hkv, D)))
    if cross:
        return (q, k, v, torch.arange(W, dtype=torch.int32, device="cuda")[None].repeat(B, 1),
                torch.ones((B, W), dtype=torch.bool, device="cuda"),
                torch.full((B,), W - 1, dtype=torch.int32, device="cuda"))
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
    if dt == "bfloat16":
        check_rows("flash", got, want, f"flash_attention B={B} S={S} H={H} Hkv={Hkv} D={D} "
                                       f"causal={causal} window={window}")
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
    mask = None if window is None else live  # causal alone, or no mask, takes none

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal and window is None,
                                              enable_gqa=True)

    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window)),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                                   window=window)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(torch, lib),  # yardstick only: the port never calls it
        "body": flash_body(fa, q, k),
    }
    CALL_MS[("flash", B, S)] = time_ms(
        torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window), queued=False)
    return err, rec


def decode_case(torch, F, da, ref, B, W, Hkv, G, D, dt, pos, timed=False, dead_row=False,
                dead_block=False, cross=False):
    """The kernel against the plain version. ``dead_row`` masks every slot
    of sequence 0 (its output must be exactly 0); ``dead_block`` asserts
    that the inputs leave some block of a cluster without a live slot;
    ``cross`` takes decode_inputs' cross-attention layout, every slot live."""
    dtype = getattr(torch, dt)
    H = Hkv * G
    q, k, v, kv_pos, valid, q_pos = decode_inputs(torch, B, W, H, Hkv, D, dtype, pos,
                                                  seed=B * 104729 + W * 17 + H + D,
                                                  cross=cross)
    if dead_row:
        valid[0] = False
    if dead_block:
        ns = da.cluster_size(W)
        chunk = -(-W // ns)
        live = (valid & (kv_pos <= q_pos[:, None])).cpu()
        if all(live[:, r * chunk:(r + 1) * chunk].any(dim=1).all() for r in range(ns)):
            raise AssertionError(f"decode_attention W={W} pos={pos}: every block of the "
                                 f"{ns}-block cluster holds a live slot")
    got = da.decode_attention(q, k, v, kv_pos, valid, q_pos)
    want = ref.decode_attention_ref(q, k, v, kv_pos, valid, q_pos)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    if not (got.shape == want.shape and got.dtype == q.dtype and err <= TOL[dt] * scale):
        raise AssertionError(f"decode_attention B={B} W={W} H={H} Hkv={Hkv} D={D} {dt} "
                             f"pos={pos}: err {err} > {TOL[dt] * scale}")
    if dead_row and int(torch.count_nonzero(got[0])) != 0:
        raise AssertionError("decode_attention: a fully masked row is not exactly 0")
    if dt == "bfloat16":
        check_rows("decode", got, want, f"decode_attention B={B} W={W} H={H} Hkv={Hkv} "
                                        f"D={D} pos={pos}")
    if not timed:
        return err, None
    # what the function needs: q, kv_positions, kv_valid and q_pos read once,
    # the K/V rows of live slots only (a dead slot's row need not be read),
    # the output written once
    live = valid & (kv_pos <= q_pos[:, None])
    n_live = int(live.sum())
    flops = 4 * Hkv * G * D * n_live
    nbytes = ((2 * q.numel() + 2 * n_live * Hkv * D) * q.element_size()
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
    CALL_MS[("decode", B, W)] = time_ms(
        torch, lambda: da.decode_attention(q, k, v, kv_pos, valid, q_pos), queued=False)
    return err, rec


def fmt(rec):
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    body = f" | body {rec['body']}" if "body" in rec else ""
    return (f"max_abs_err {rec['max_abs_err']:.3g} | kernel (device) {rec['ms']:.4f} ms | "
            f"plain {rec['plain_ms']:.4f} ms | library {lib} | "
            f"bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}){body}")


def flash_body(fa, q, k):
    """The body flash_attention launches for these inputs."""
    return ("float32", "mma.sync", "wgmma")[fa.body(q.dtype, q.shape[1],
                                                    q.shape[2] // k.shape[2])]


def ssd_inputs(torch, B, S, H, P, N, dtype, with_init, seed):
    """The value distribution of tests/test_kernels.py's SSD test."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32)

    x = (randn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H))
    A = -torch.exp(randn(H) * 0.3)
    B_, C_ = ((randn(B, S, N) * 0.5).to(dtype) for _ in range(2))
    init = randn(B, H, P, N) * 0.2 if with_init else None
    return x, dt, A, B_, C_, init


def ssd_case(torch, sk, ref, B, nc, Q, H, P, N, dt, with_init, timed=False):
    """The kernel against the chunked form and the recurrence. Returns the
    errors (the kernel's against the chunked form and against the
    recurrence, and the chunked form's own distance from the recurrence)
    and, when timed, the kernel record."""
    dtype = getattr(torch, dt)
    S = nc * Q
    x, dtv, A, B_, C_, init = ssd_inputs(torch, B, S, H, P, N, dtype, with_init,
                                         seed=B * 7919 + S * 31 + H * 7 + P + N)
    y, st = sk.ssd_scan(x, dtv, A, B_, C_, Q, init)
    y_ref, st_ref = ref.ssd_scan_ref(x, dtv, A, B_, C_, Q, init)
    y_seq, st_seq = ref.ssd_scan_sequential_ref(x, dtv, A, B_, C_, init)
    torch.cuda.synchronize()
    what = f"ssd_scan B={B} S={S} Q={Q} H={H} P={P} N={N} {dt} init={with_init}"
    if not (y.shape == x.shape and y.dtype == dtype and st.dtype == torch.float32
            and st.shape == (B, H, P, N)):
        raise AssertionError(f"{what}: outputs {y.shape} {y.dtype} {st.shape} {st.dtype}")
    absolute = dt == "float32" and Q <= SSD_ABS_Q
    errs = {}
    for kind, (yr, sr) in (("chunked", (y_ref, st_ref)), ("sequential", (y_seq, st_seq))):
        tol = SSD_TOL32[kind] if dt == "float32" else TOL[dt]
        for name, got, want in (("y", y, yr), ("state", st, sr)):
            err, scale = max_err(torch, got, want)
            if absolute:
                scale = 1.0
            if not err <= tol * scale:
                raise AssertionError(f"{what}: {name} vs {kind} err {err} > {tol * scale}")
            errs[(kind, name)] = err
    if dt == "bfloat16":  # row by row against the chunked form: y over P, state over N
        check_rows("ssd_scan", y, y_ref, f"{what} y")
        check_rows("ssd_scan", st, st_ref, f"{what} state")
    floor = max(max_err(torch, y_ref, y_seq)[0], max_err(torch, st_ref, st_seq)[0])
    err = max(errs[("chunked", "y")], errs[("chunked", "state")])
    seq_err = max(errs[("sequential", "y")], errs[("sequential", "state")])
    log("kernels", f"{what}: kernel vs chunked {err:.3g} | vs recurrence: kernel "
                   f"{seq_err:.3g}, chunked form {floor:.3g} | max|ref| y "
                   f"{float(y_seq.float().abs().max()):.3g}, state "
                   f"{float(st_seq.abs().max()):.3g} | bars "
                   f"{'absolute' if absolute else 'x max(|ref|, 1)'}")
    if not timed:
        return err, seq_err, floor, None
    # what the function needs: x, dt, A, B, C (and an initial state) read once,
    # y and the final state written once; C.B^T over the live (j <= i) pairs once
    # (shared by the heads), then per head the decayed scores times x, the
    # chunk's state update and, where a state enters the chunk, C.state
    itemsize = x.element_size()
    nbytes = ((x.numel() + B_.numel() + C_.numel() + y.numel()) * itemsize
              + (dtv.numel() + A.numel() + st.numel()) * 4
              + (init.numel() * 4 if with_init else 0))
    pairs = Q * (Q + 1) // 2
    entering = nc if with_init else nc - 1
    flops = (2 * B * nc * pairs * N
             + 2 * B * H * (nc * (pairs * P + Q * N * P) + entering * Q * N * P))
    bound_ms, bound_by = bound(nbytes, flops, dt)
    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: sk.ssd_scan(x, dtv, A, B_, C_, Q, init)),
        "plain_ms": time_ms(torch, lambda: ref.ssd_scan_ref(x, dtv, A, B_, C_, Q, init)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the SSD scan
    }
    CALL_MS[("ssd", B, S)] = time_ms(
        torch, lambda: sk.ssd_scan(x, dtv, A, B_, C_, Q, init), queued=False)
    return err, seq_err, floor, rec


def phase_ssd_kernel(torch):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk

    # the serving path: every full mamba2-1.3b prefill pads its prompt to one
    # 256-token chunk and scans it with H=64, P=64, N=128 in bf16, no state
    _, _, _, rec = ssd_case(torch, sk, ref, 1, 1, 256, 64, 64, 128, "bfloat16", False,
                            timed=True)
    log("kernels", f"ssd_scan B=1 S=Q=256 H=64 P=64 N=128 bf16 no init: {fmt(rec)}"
                   f" | wrapper call {CALL_MS[('ssd', 1, 256)]:.4f} ms")
    # zamba2-7b's prefill: one 256-token chunk at H=112 (56 head pairs), N=64
    _, _, _, zrec = ssd_case(torch, sk, ref, 1, 1, 256, 112, 64, 64, "bfloat16", False,
                             timed=True)
    log("kernels", f"ssd_scan zamba2 B=1 S=Q=256 H=112 P=64 N=64 bf16 no init: {fmt(zrec)}"
                   f" | wrapper call {CALL_MS[('ssd', 1, 256)]:.4f} ms")
    # granite-4.0-h-small's prefill: H=128 heads of P=64, N=128, a 1024-token
    # prompt (4 chunks), alone and in the cell's largest batch of 8
    for B in (1, 8):
        _, _, _, grec = ssd_case(torch, sk, ref, B, 4, 256, 128, 64, 128, "bfloat16", False,
                                 timed=True)
        log("kernels", f"ssd_scan granite B={B} S=1024 Q=256 H=128 P=64 N=128 bf16 no init: "
                       f"{fmt(grec)}")
    worst, n = {"float32": 0.0, "bfloat16": 0.0}, 0
    worst256 = {"kernel": 0.0, "chunked": 0.0}  # f32 distance from the recurrence, Q=256
    grid = ((1, 1, 256, 64, 64, 128), (2, 2, 256, 8, 64, 128), (1, 4, 256, 2, 32, 64),
            (2, 3, 64, 4, 64, 32), (1, 4, 64, 16, 32, 128), (2, 1, 32, 2, 32, 32),
            (1, 4, 32, 64, 64, 64), (2, 2, 32, 3, 64, 128),
            (1, 1, 256, 112, 64, 64), (1, 2, 256, 112, 64, 64),  # zamba2
            (2, 2, 256, 128, 64, 128))  # granite
    for dt in ("float32", "bfloat16"):
        for B, nc, Q, H, P, N in grid:
            for with_init in (False, True):
                err, seq_err, floor, _ = ssd_case(torch, sk, ref, B, nc, Q, H, P, N, dt,
                                                  with_init)
                worst[dt], n = max(worst[dt], err), n + 1
                if dt == "float32" and Q > SSD_ABS_Q:
                    worst256["kernel"] = max(worst256["kernel"], seq_err)
                    worst256["chunked"] = max(worst256["chunked"], floor)
    log("kernels", f"ssd_scan grid: {n} cases within tolerance against the chunked form "
                   f"and the recurrence (max abs err vs chunked: f32 {worst['float32']:.3g}, "
                   f"bf16 {worst['bfloat16']:.3g}; f32 at Q=256 vs the recurrence: kernel "
                   f"{worst256['kernel']:.3g}, chunked form {worst256['chunked']:.3g}; bf16 rows: "
                   f"worst err {ROW_RATIO['ssd_scan']:.3g} x max(|ref row|, {ROW_FLOOR}), bar "
                   f"{TOL['bfloat16']})")
    return rec


def gmm_inputs(torch, E, C, D, F, dtype, strided, seed, live=None):
    """buf (E, C, D), as a view [:, :C] of an (E, C+1, D) buffer when
    ``strided`` (as the MoE block passes it), and w (E, D, F) scaled by
    D**-0.5 as the model's expert weights are. ``live``, when given, lists
    (expert, rows): only those experts hold tokens, in their first ``rows``
    rows, and every other row is 0, as the dispatch leaves the buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    full = torch.randn((E, C + int(strided), D), generator=g, device="cuda").to(dtype)
    if live is not None:
        keep = torch.zeros((E, C + int(strided), 1), dtype=torch.bool, device="cuda")
        for e, rows in live:
            keep[e, :rows] = True
        full = torch.where(keep, full, torch.zeros((), dtype=dtype, device="cuda"))
    w = torch.randn((E, D, F), generator=g, device="cuda").mul_(D ** -0.5).to(dtype)
    return full[:, :C], w


def gmm_case(torch, gk, ref, E, C, D, F, dt, strided, timed=False, live=None):
    """The kernel against the plain version; ``live`` as gmm_inputs takes
    it. Rows that hold no token must come out exactly 0."""
    dtype = getattr(torch, dt)
    buf, w = gmm_inputs(torch, E, C, D, F, dtype, strided, seed=E * 7919 + C * 31 + D + F,
                        live=live)
    got = gk.moe_gmm(buf, w)
    want = ref.moe_gmm_ref(buf, w)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    what = f"moe_gmm E={E} C={C} D={D} F={F} {dt} strided={strided} live={live}"
    if not (got.shape == (E, C, F) and got.dtype == dtype and err <= TOL[dt] * scale):
        raise AssertionError(f"{what}: err {err} > {TOL[dt] * scale}")
    if dt == "bfloat16":
        check_rows("moe_gmm", got, want, what)
    live_rows = (buf != 0).any(dim=2)  # (E, C)
    if int(torch.count_nonzero(got[~live_rows])) != 0:
        raise AssertionError(f"{what}: a row without a token is not exactly 0")
    if not timed:
        return err, None
    # what the function needs: buf read once, the weights of the experts
    # that hold a token (a dead expert's product is 0 whatever its weights),
    # out written once; 2 flops per live row and weight element
    live_experts = int(live_rows.any(dim=1).sum())
    nbytes = (buf.numel() + live_experts * D * F + got.numel()) * buf.element_size()
    bound_ms, bound_by = bound(nbytes, 2 * int(live_rows.sum()) * D * F, dt)
    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: gk.moe_gmm(buf, w)),
        "plain_ms": time_ms(torch, lambda: ref.moe_gmm_ref(buf, w)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # yardstick only: the port never calls it
        "library_ms": time_ms(torch, lambda: torch.bmm(buf, w)),
    }
    CALL_MS[("moe_gmm", C, D, live is None)] = time_ms(torch, lambda: gk.moe_gmm(buf, w),
                                                       queued=False)
    return err, rec


def phase_moe_kernel(torch):
    from repro_torch.kernels import moe_gmm as gk
    from repro_torch.kernels import ref

    # the serving path: full mixtral (E=8, D=4096, F=14336, bf16) at batch 1
    # has capacity C = 8 (prompts of 8 and 24, every decode step) or 16
    # (prompt 48); gate and up read (8, 4096, 14336), down (8, 14336, 4096);
    # buf is the strided view of the scatter buffer. A decode step's token
    # routes to 2 of the 8 experts, which hold 1 row each; the other rows are
    # 0. The JSON record is the decode step's gate / up product, the most
    # frequent launch, at that shape.
    decode = {}
    for D, F, live in ((4096, 14336, [(1, 1), (5, 1)]), (14336, 4096, [(2, 1), (6, 1)])):
        _, rec = gmm_case(torch, gk, ref, 8, 8, D, F, "bfloat16", True, timed=True, live=live)
        decode[D] = rec
        log("kernels", f"moe_gmm served decode E=8 C=8 D={D} F={F} bf16 strided buf, experts "
                       f"{[e for e, _ in live]} of 8 live with 1 row each: {fmt(rec)} | wrapper "
                       f"call {CALL_MS[('moe_gmm', 8, D, False)]:.4f} ms")
    records = {}
    for C in (8, 16):
        for D, F in ((4096, 14336), (14336, 4096)):
            _, rec = gmm_case(torch, gk, ref, 8, C, D, F, "bfloat16", True, timed=True)
            records[(C, D)] = rec
            log("kernels", f"moe_gmm E=8 C={C} D={D} F={F} bf16 strided buf, all experts live: "
                           f"{fmt(rec)} | wrapper call {CALL_MS[('moe_gmm', C, D, True)]:.4f} ms")
    log("kernels", f"moe_gmm gate/up: served decode {decode[4096]['ms']:.4f} ms vs all live at "
                   f"C=8 {records[(8, 4096)]['ms']:.4f} ms: "
                   f"{records[(8, 4096)]['ms'] / decode[4096]['ms']:.2f}x faster; vs torch.bmm "
                   f"on the decode input {decode[4096]['library_ms']:.4f} ms: "
                   f"{decode[4096]['library_ms'] / decode[4096]['ms']:.2f}x faster")
    # granite-4.0-h-small's decode steps (E=72, top-10, dropless: 8 tokens or
    # fewer go through the (72, 8, D) buffers): gate / up D=4096 F=768, down
    # D=768 F=4096. A batch of 1 fills 10 experts with 1 row each; a batch of
    # 8 routes 80 rows, about 50 experts live, here 30 with 2 rows and 20 with 1
    for D, F in ((4096, 768), (768, 4096)):
        for live in ([(7 * i, 1) for i in range(10)],
                     [(72 * i // 50, 2 if i < 30 else 1) for i in range(50)]):
            gmm_case(torch, gk, ref, 72, 8, D, F, "float32", True, live=live)
            _, rec = gmm_case(torch, gk, ref, 72, 8, D, F, "bfloat16", True, timed=True,
                              live=live)
            log("kernels", f"moe_gmm granite decode E=72 C=8 D={D} F={F} bf16 strided buf, "
                           f"{len(live)} of 72 experts live with {sum(r for _, r in live)} rows "
                           f"(f32 within TOL too): {fmt(rec)} | wrapper call "
                           f"{CALL_MS[('moe_gmm', 8, D, False)]:.4f} ms")
    worst, n, n_strided = {"float32": 0.0, "bfloat16": 0.0}, 0, 0
    for dt in ("float32", "bfloat16"):
        for E in (1, 2, 8):
            for C in (8, 13, 16, 100):
                for D in (64, 130, 4096):
                    for F in (72, 4096, 14336):
                        strided = n % 2 == 1
                        err, _ = gmm_case(torch, gk, ref, E, C, D, F, dt, strided)
                        worst[dt], n, n_strided = max(worst[dt], err), n + 1, n_strided + strided
    n_dead = 0
    for dt in ("float32", "bfloat16"):
        for E, C, D, F in ((8, 8, 256, 320), (2, 13, 130, 72), (8, 8, 4096, 14336),
                           (8, 16, 14336, 4096)):
            # no expert live; one expert full; two experts with some rows
            for live in ([], [(E - 1, C)], [(0, min(3, C)), (E // 2, 1)]):
                err, _ = gmm_case(torch, gk, ref, E, C, D, F, dt, True, live=live)
                worst[dt], n_dead = max(worst[dt], err), n_dead + 1
    log("kernels", f"moe_gmm grid: {n} cases ({n_strided} on a strided buf view) and {n_dead} "
                   f"with experts that hold no token (rows without one exactly 0) within TOL "
                   f"(max abs err f32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}; bf16 "
                   f"rows: worst err {ROW_RATIO['moe_gmm']:.3g} x max(|ref row|, {ROW_FLOOR}), "
                   f"bar {TOL['bfloat16']})")
    return decode[4096]


def grouped_inputs(torch, R, D, F, seed, E=8, K=2):
    """R rows of R / K tokens, each routed to K distinct of E experts drawn
    uniformly, sorted by expert as the dropless dispatch sorts them, and w
    (E, D, F) scaled by D**-0.5, bf16: (x, w, offsets)."""
    from repro_torch.models import moe as MOE

    g = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.rand((R // K, E), generator=g, device="cuda").topk(K, dim=-1).indices
    order, offsets = MOE.sort_by_expert(ids, E)
    x = torch.randn((R // K, D), generator=g, device="cuda").to(torch.bfloat16)
    w = torch.randn((E, D, F), generator=g, device="cuda").mul_(D ** -0.5).to(torch.bfloat16)
    return x[order // K].contiguous(), w, offsets


def grouped_case(torch, ops, ref, R, D, F, E=8, K=2):
    """The grouped product against its plain version (mixtral's widths by
    default), within TOL and row by row, and its times: the kernel
    (queued), its bound (x and out once, the weights of the experts that
    hold a row; 2 flops a row and weight element), the plain version and
    the library's grouped product (``torch._grouped_mm``, where this
    PyTorch has it)."""
    x, w, offsets = grouped_inputs(torch, R, D, F, seed=R + D + F + E, E=E, K=K)
    got = ops.moe_gmm_grouped(x, w, offsets)
    want = ref.moe_gmm_grouped_ref(x, w, offsets)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    what = f"moe_gmm_grouped E={E} K={K} R={R} D={D} F={F} bf16"
    if not (got.shape == (R, F) and got.dtype == torch.bfloat16 and err <= TOL["bfloat16"] * scale):
        raise AssertionError(f"{what}: err {err} > {TOL['bfloat16'] * scale}")
    check_rows("moe_gmm_grouped", got, want, what)
    live = int((offsets[1:] > offsets[:-1]).sum())
    bound_ms, bound_by = bound((live * D * F + R * D + R * F) * 2, 2 * R * D * F, "bfloat16")
    library = getattr(torch, "_grouped_mm", None)
    rec = {"R": R, "D": D, "F": F, "E": E, "live_experts": live, "max_abs_err": err,
           "ms": time_ms(torch, lambda: ops.moe_gmm_grouped(x, w, offsets), iters=20),
           # the plain version reads the offsets on the host: not queued
           "plain_ms": time_ms(torch, lambda: ref.moe_gmm_grouped_ref(x, w, offsets), iters=3,
                               warmup=1, queued=False),
           "bound_ms": bound_ms, "bound_by": bound_by,
           # yardstick only: the port never calls it
           "library_ms": (time_ms(torch, lambda: library(x, w, offs=offsets[1:]), iters=20)
                          if library is not None else None)}
    rec["roofline_pct"] = 100 * bound_ms / rec["ms"]
    return rec


def layer_dispatch_ms(torch):
    """One mixtral layer's experts at full width over one 8,192-token batch
    (random weights, bf16), dispatched with capacity 1.25 (the (E, C, D)
    buffers, ops.moe_gmm) and dropless (sorted rows, ops.moe_gmm_grouped),
    in turns: capacity, dropless, dropless, capacity. Each: the three
    products' device time on the dispatched inputs and the whole block's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE

    full = get_config("mixtral-8x7b-16l")
    g = torch.Generator(device="cuda").manual_seed(1)
    p = MOE.init_moe(g, full, device="cuda")
    T, E, K = 8192, full.num_experts, full.experts_per_token
    xt = torch.randn((T, full.d_model), generator=g, device="cuda").to(torch.bfloat16)
    _, _, ids = MOE.route(p, full, xt)
    C = MOE.moe_capacity(full, T)
    flat, slot, keep = MOE.dispatch(ids, E, C)
    buf = torch.zeros((E, C + 1, full.d_model), dtype=xt.dtype, device="cuda")
    buf[flat, torch.where(keep, slot, C)] = xt[torch.arange(T, device="cuda").repeat(K)]
    buf = buf[:, :C]
    order, offsets = MOE.sort_by_expert(ids, E)
    rows = xt[order // K].contiguous()
    hc = torch.randn((E, C, full.d_ff), generator=g, device="cuda").to(xt.dtype)
    hd = torch.randn((T * K, full.d_ff), generator=g, device="cuda").to(xt.dtype)
    sides = {
        "capacity": (dataclasses.replace(full, moe_capacity_factor=1.25), E * C,
                     [lambda: ops.moe_gmm(buf, p["wg"]), lambda: ops.moe_gmm(buf, p["wu"]),
                      lambda: ops.moe_gmm(hc, p["wd"])]),
        "dropless": (dataclasses.replace(full, moe_capacity_factor=None), T * K,
                     [lambda: ops.moe_gmm_grouped(rows, p["wg"], offsets),
                      lambda: ops.moe_gmm_grouped(rows, p["wu"], offsets),
                      lambda: ops.moe_gmm_grouped(hd, p["wd"], offsets)])}
    out = {}
    for side in ("capacity", "dropless", "dropless", "capacity"):
        cfg, n_rows, fns = sides[side]
        products = sum(time_ms(torch, f, iters=5, warmup=1) for f in fns)
        block = time_ms(torch, lambda: MOE.moe_block(p, cfg, xt[None]), iters=5, warmup=1)
        out.setdefault(side, []).append((products, block))
        log("kernels", f"moe layer over {T} tokens, {side} ({n_rows} rows): expert products "
                       f"{products:.4f} ms, moe_block {block:.4f} ms")
    return out


def phase_moe_grouped(torch):
    """The grouped product of the dropless dispatch on the card, at the
    shapes the benchmark's cells run. Mixtral (8 experts, top-2): R = 2 and
    16 (a decode step's rows, which the dispatch sends to moe_gmm instead),
    2,048 and 16,384 rows at the gate / up widths, 16,384 at the down
    widths. Granite-4.0-h-small (72 experts, top-10): prefills of 256, 2,048
    and 8,192 tokens (8 prompts of 1,024, the cell's largest), R = 2,560,
    20,480 and 81,920, at the gate / up (4096, 768) and down (768, 4096)
    widths. Then one mixtral layer's experts over 8,192 tokens on both
    dispatches."""
    from repro_torch.kernels import ops, ref

    cases = [(R, D, F, 8, 2) for R, D, F in (
        (2, 4096, 14336), (16, 4096, 14336), (2048, 4096, 14336), (16384, 4096, 14336),
        (16384, 14336, 4096))]
    cases += [(10 * T, D, F, 72, 10) for T in (256, 2048, 8192)
              for D, F in ((4096, 768), (768, 4096))]
    recs = {}
    with torch.inference_mode():
        for R, D, F, E, K in cases:
            rec = recs[(R, D)] = grouped_case(torch, ops, ref, R, D, F, E=E, K=K)
            lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
            log("kernels", f"moe_gmm_grouped {'mixtral' if E == 8 else 'granite'} R={R} D={D} "
                           f"F={F} bf16, top-{K}, {rec['live_experts']} of {E} experts live: "
                           f"kernel {rec['ms']:.4f} ms, bound "
                           f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                           f"{rec['roofline_pct']:.1f}%), plain {rec['plain_ms']:.4f} ms, "
                           f"torch._grouped_mm {lib} ms, max abs err {rec['max_abs_err']:.3g}")
        layer = layer_dispatch_ms(torch)
    log("kernels", f"moe_gmm_grouped rows: worst err {ROW_RATIO['moe_gmm_grouped']:.3g} x "
                   f"max(|ref row|, {ROW_FLOOR}), bar {TOL['bfloat16']}")
    cap = min(p for p, _ in layer["capacity"])
    drop = min(p for p, _ in layer["dropless"])
    if drop > cap:
        raise AssertionError(f"moe layer over 8192 tokens: dropless products {drop:.4f} ms "
                             f"slower than capacity {cap:.4f} ms")
    rec = recs[(16384, 4096)]
    return {k: rec[k] for k in ("R", "D", "F", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}


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
    # mixtral-8x7b-16l (H=32, Hkv=8, D=128, sliding window 4096) prefills the
    # same prompts with the same bf16 kernel
    for S in (8, 24, 48):
        _, rec = flash_case(torch, F, fa, ref, 1, S, 8, 4, 128, "bfloat16", True, 4096,
                            timed=True)
        log("kernels", f"flash_attention mixtral B=1 S={S} H=32 Hkv=8 D=128 bf16 causal "
                       f"window=4096: {fmt(rec)} | wrapper call "
                       f"{CALL_MS[('flash', 1, S)]:.4f} ms")
    # zamba2-7b's shared attention block (H=Hkv=32, D=112, no window) prefills
    # the prompt padded only to the longest of its batch (48 at most here);
    # the SSD scan pads its own tail to the 256-token chunk
    _, rec = flash_case(torch, F, fa, ref, 1, 48, 32, 1, 112, "bfloat16", True, None,
                        timed=True)
    log("kernels", f"flash_attention zamba2 B=1 S=48 H=32 Hkv=32 D=112 bf16 causal: "
                   f"{fmt(rec)} | wrapper call {CALL_MS[('flash', 1, 48)]:.4f} ms")
    # the longest prefill of nemotron, codeqwen, phi3 and internvl2: a 48-token
    # prompt, behind internvl2's 256 patch embeddings
    for name, S, Hkv, G, D in DENSE_ATTN:
        _, rec = flash_case(torch, F, fa, ref, 1, S, Hkv, G, D, "bfloat16", True, None,
                            timed=True)
        log("kernels", f"flash_attention {name} B=1 S={S} H={Hkv * G} Hkv={Hkv} D={D} bf16 "
                       f"causal: {fmt(rec)} | wrapper call {CALL_MS[('flash', 1, S)]:.4f} ms")
    # whisper-tiny (H=Hkv=6, D=64): the decoder's longest prefill, and the
    # encoder's bidirectional attention over its 1500 frames
    for S, causal in ((48, True), (ENC_SEQ, False)):
        _, rec = flash_case(torch, F, fa, ref, 1, S, WHISPER_HKV, 1, WHISPER_D, "bfloat16",
                            causal, None, timed=True)
        log("kernels", f"flash_attention whisper {'decoder' if causal else 'encoder'} B=1 "
                       f"S={S} H=6 Hkv=6 D=64 bf16 {'causal' if causal else 'non-causal'}: "
                       f"{fmt(rec)} | wrapper call {CALL_MS[('flash', 1, S)]:.4f} ms")
    # beyond the path: a long prefill, where the tensor cores' rate matters
    _, rec = flash_case(torch, F, fa, ref, 1, 2048, 2, 8, 128, "bfloat16", True, None,
                        timed=True)
    log("kernels", f"flash_attention long B=1 S=2048 H=16 Hkv=2 D=128 bf16 causal: {fmt(rec)}"
                   f" | wrapper call {CALL_MS[('flash', 1, 2048)]:.4f} ms")
    worst, n = 0.0, 0
    for dt in ("bfloat16", "float32"):
        for Hkv, G, D in ((2, 8, 128), (2, 2, 64), (1, 4, 64), (4, 1, 128), (2, 8, 96),
                          (1, 16, 112)):
            for S in (8, 33, 48, 96, 200):
                for causal, window in ((True, None), (True, 32), (False, None), (False, 32)):
                    err, _ = flash_case(torch, F, fa, ref, 2 if S < 96 else 1, S, Hkv, G, D,
                                        dt, causal, window)
                    worst, n = max(worst, err), n + 1
        for S, window in ((2048, None), (200, 64), (4096, 1024)):
            err, _ = flash_case(torch, F, fa, ref, 1, S, 2, 8, 128, dt, True, window)
            worst, n = max(worst, err), n + 1
        for S in (8, 24, 48):  # mixtral's prefill
            err, _ = flash_case(torch, F, fa, ref, 1, S, 8, 4, 128, dt, True, 4096)
            worst, n = max(worst, err), n + 1
        for S in (8, 48, 256, 512):  # zamba2's prompts, and one and two SSD chunks' worth
            err, _ = flash_case(torch, F, fa, ref, 1, S, 32, 1, 112, dt, True, None)
            worst, n = max(worst, err), n + 1
        # nemotron (G = 6): position s owns packed rows 6s..6s+5, so S = 3 puts
        # position 2 across the first warp's 16-row tile, S = 11 position 10
        # across the block's 64-row tile; S = 8 ends inside a warp, S = 48
        # spans 4.5 blocks. Then codeqwen's and phi3's prompts, and
        # internvl2's 256 patches + prompts of 8, 24 and 48
        for B, S, Hkv, G, D in ((1, 3, 8, 6, 128), (2, 8, 8, 6, 128), (2, 11, 8, 6, 128),
                                (1, 24, 8, 6, 128), (1, 48, 8, 6, 128), (1, 8, 32, 1, 128),
                                (1, 48, 32, 1, 128), (1, 8, 32, 1, 96), (1, 48, 32, 1, 96),
                                (1, 264, 8, 8, 128), (1, 280, 8, 8, 128), (1, 304, 8, 8, 128)):
            err, _ = flash_case(torch, F, fa, ref, B, S, Hkv, G, D, dt, True, None)
            worst, n = max(worst, err), n + 1
        # whisper-tiny: the decoder's prompts, and the encoder over 1500 frames
        for B, S, causal in ((1, 8, True), (1, 24, True), (2, 48, True), (1, ENC_SEQ, False),
                             (2, ENC_SEQ, False)):
            err, _ = flash_case(torch, F, fa, ref, B, S, WHISPER_HKV, 1, WHISPER_D, dt, causal,
                                None)
            worst, n = max(worst, err), n + 1
    log("kernels", f"flash_attention grid: {n} cases within TOL, head dims 64/96/112/128, "
                   f"groups 1-16, S up to 2048, mixtral's, zamba2's, nemotron's (G=6 across "
                   f"the 16- and 64-row tiles), codeqwen's, phi3's, internvl2's (S 264-304) and "
                   f"whisper's prefill (S 8-48 causal) and encoder (S 1500 non-causal) "
                   f"(max abs err {worst:.3g}; "
                   f"bf16 rows: worst err {ROW_RATIO['flash']:.3g} x max(|ref row|, "
                   f"{ROW_FLOOR}), bar {TOL['bfloat16']})")

    # decode: ring window 128 + the self slot = 129 slots; the longest
    # path prompt (48) after 15 decoded tokens sits at position 63
    for B, pos in ((1, [63]), (3, [40, 200, 128])):
        _, rec = decode_case(torch, F, da, ref, B, 129, 2, 8, 128, "bfloat16", pos, timed=True)
        log("kernels", f"decode_attention B={B} W=129 H=16 Hkv=2 D=128 bf16 pos={pos}: "
                       f"{fmt(rec)} | wrapper call {CALL_MS[('decode', B, 129)]:.4f} ms")
        path_records[("decode", B)] = rec
    # mixtral-8x7b-16l's decode step: H=32, Hkv=8, D=128 over the same ring
    _, rec = decode_case(torch, F, da, ref, 1, 129, 8, 4, 128, "bfloat16", [63], timed=True)
    log("kernels", f"decode_attention mixtral B=1 W=129 H=32 Hkv=8 D=128 bf16 pos=[63]: "
                   f"{fmt(rec)} | wrapper call {CALL_MS[('decode', 1, 129)]:.4f} ms")
    # zamba2-7b's decode step: H=Hkv=32, D=112; its longest prompt (48) after
    # 15 decoded tokens sits at position 63, the 128-slot ring half full
    _, rec = decode_case(torch, F, da, ref, 1, 129, 32, 1, 112, "bfloat16", [63], timed=True)
    log("kernels", f"decode_attention zamba2 B=1 W=129 H=32 Hkv=32 D=112 bf16 pos=[63]: "
                   f"{fmt(rec)} | wrapper call {CALL_MS[('decode', 1, 129)]:.4f} ms")
    # the last decode step of nemotron, codeqwen, phi3 and internvl2: a 48-token
    # prompt (behind 256 patches for internvl2) and 15 decoded tokens
    for name, S, Hkv, G, D in DENSE_ATTN:
        pos = [S + SERVE_MAX_NEW - 1]
        _, rec = decode_case(torch, F, da, ref, 1, 129, Hkv, G, D, "bfloat16", pos, timed=True)
        log("kernels", f"decode_attention {name} B=1 W=129 H={Hkv * G} Hkv={Hkv} D={D} bf16 "
                       f"pos={pos}: {fmt(rec)} | wrapper call "
                       f"{CALL_MS[('decode', 1, 129)]:.4f} ms")
    # whisper-tiny's decode step: its decoder's ring (a 48-token prompt and
    # 15 decoded tokens), and the cross-attention over the 1500 cached frames
    _, rec = decode_case(torch, F, da, ref, 1, 129, WHISPER_HKV, 1, WHISPER_D, "bfloat16",
                         [63], timed=True)
    log("kernels", f"decode_attention whisper ring B=1 W=129 H=6 Hkv=6 D=64 bf16 pos=[63]: "
                   f"{fmt(rec)} | wrapper call {CALL_MS[('decode', 1, 129)]:.4f} ms")
    _, rec = decode_case(torch, F, da, ref, 1, ENC_SEQ, WHISPER_HKV, 1, WHISPER_D,
                         "bfloat16", None, timed=True, cross=True)
    log("kernels", f"decode_attention whisper cross B=1 W={ENC_SEQ} H=6 Hkv=6 D=64 bf16 "
                   f"every slot live (q_pos {ENC_SEQ - 1}): {fmt(rec)} | wrapper call "
                   f"{CALL_MS[('decode', 1, ENC_SEQ)]:.4f} ms")
    # beyond the path: mixtral's widths at its full 4096-slot window + self slot
    _, rec = decode_case(torch, F, da, ref, 1, 4097, 8, 4, 128, "bfloat16", [5000],
                         timed=True)
    log("kernels", f"decode_attention long B=1 W=4097 H=32 Hkv=8 D=128 bf16 pos=[5000]: "
                   f"{fmt(rec)} | wrapper call {CALL_MS[('decode', 1, 4097)]:.4f} ms")
    log("build", "decode_attention: cudaLaunchKernelEx with a cluster dimension (NS, 1, 1) "
                 "over grid (NS, Hkv, B): NS = " + ", ".join(
                     f"{da.cluster_size(W)} at W={W}" for W in (1, 17, 65, 129, 400, 4097)))
    worst, n = 0.0, 0
    for dt in ("bfloat16", "float32"):
        for Hkv, G, D in ((2, 8, 128), (2, 2, 64), (8, 1, 128), (1, 16, 64), (2, 8, 96),
                          (8, 4, 112), (8, 4, 128)):
            for W in (17, 65, 129, 131, 400, 4097):  # 1, 1, 1, 1, 2 and 4 (f32: 2) slot groups
                for B, pos in ((1, [1]), (2, [W // 2, W - 1]), (3, [W, 2 * W + 5, 5 * W // 2])):
                    err, _ = decode_case(torch, F, da, ref, B, W, Hkv, G, D, dt, pos)
                    worst, n = max(worst, err), n + 1
            decode_case(torch, F, da, ref, 2, 129, Hkv, G, D, dt, [70, 300], dead_row=True)
            # a half-filled ring: blocks 3-6 of the 8-block cluster hold no live slot
            err, _ = decode_case(torch, F, da, ref, 2, 129, Hkv, G, D, dt, [50, 20],
                                 dead_block=True)
            worst, n = max(worst, err), n + 2
        for pos in ([263], [63]):  # zamba2's decode step, its ring full and half full
            err, _ = decode_case(torch, F, da, ref, 1, 129, 32, 1, 112, dt, pos)
            worst, n = max(worst, err), n + 1
        # the steps of nemotron (a young ring, a half-filled one, a wrapped
        # batch), codeqwen, phi3 and internvl2 (its ring full behind the patches)
        for B, Hkv, G, D, pos in ((1, 8, 6, 128, [9]), (1, 8, 6, 128, [63]),
                                  (2, 8, 6, 128, [30, 300]), (1, 32, 1, 128, [63]),
                                  (1, 32, 1, 96, [63]), (1, 8, 8, 128, [263]),
                                  (2, 8, 8, 128, [280, 319])):
            err, _ = decode_case(torch, F, da, ref, B, 129, Hkv, G, D, dt, pos)
            worst, n = max(worst, err), n + 1
        # whisper-tiny's steps: the ring young, half full and wrapped, and the
        # cross-attention over the 1500 frames
        for B, pos in ((1, [9]), (1, [63]), (2, [30, 300])):
            err, _ = decode_case(torch, F, da, ref, B, 129, WHISPER_HKV, 1, WHISPER_D, dt, pos)
            worst, n = max(worst, err), n + 1
        for B in (1, 2):
            err, _ = decode_case(torch, F, da, ref, B, ENC_SEQ, WHISPER_HKV, 1, WHISPER_D, dt,
                                 None, cross=True)
            worst, n = max(worst, err), n + 1
    log("kernels", f"decode_attention grid: {n} cases within TOL, head dims 64/96/112/128, "
                   f"W 17-4097 (1, 2 and 4 slot groups), zamba2's step (H=Hkv=32, D=112), "
                   f"nemotron's (G=6), codeqwen's, phi3's, internvl2's and whisper's steps "
                   f"(its cross-attention at W=1500, every slot live), "
                   f"incl. fully masked rows (exactly 0) "
                   f"and cluster blocks with no live slot (max abs err {worst:.3g}; bf16 rows: "
                   f"worst err {ROW_RATIO['decode']:.3g} x max(|ref row|, {ROW_FLOOR}), "
                   f"bar {TOL['bfloat16']})")
    granite_scale(torch, ref)
    return path_records[("flash", 1, 48)], path_records[("decode", 1)]


def granite_scale(torch, ref):
    """Granite's attention (H=32, Hkv=8, D=128, no positions) at its softmax
    scale 1/128: flash over prompts of 64 and 1024 at batch 1 and 8, a
    decode step over its 1032-slot ring, each against the plain version
    at the same scale; the default scale still 1/sqrt(D), bit for bit."""
    from repro_torch.kernels import ops

    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for B, S in ((1, 64), (8, 1024)):
            g = torch.Generator(device="cuda").manual_seed(S + B)
            q = torch.randn((B, S, 32, 128), generator=g, device="cuda").to(dt)
            k, v = (torch.randn((B, S, 8, 128), generator=g, device="cuda").to(dt)
                    for _ in range(2))
            got = ops.flash_attention(q, k, v, scale=1 / 128)
            err, scale = max_err(torch, got, ref.flash_attention_ref(q, k, v, scale=1 / 128))
            if not torch.equal(ops.flash_attention(q, k, v),
                               ops.flash_attention(q, k, v, scale=128 ** -0.5)):
                raise AssertionError("flash: the default scale is not 1/sqrt(D)")
            p = torch.full((B,), S, dtype=torch.int32, device="cuda")
            kv_pos, valid = ring_tables(torch, p, 1032)
            kd, vd = (torch.randn((B, 1033, 8, 128), generator=g, device="cuda").to(dt)
                      for _ in range(2))
            got_d = ops.decode_attention(q[:, -1:].contiguous(), kd, vd, kv_pos, valid, p,
                                         scale=1 / 128)
            err_d, scale_d = max_err(torch, got_d, ref.decode_attention_ref(
                q[:, -1:].contiguous(), kd, vd, kv_pos, valid, p, scale=1 / 128))
            bar = TOL["bfloat16" if dt == torch.bfloat16 else "float32"]
            if err > bar * scale or err_d > bar * scale_d:
                raise AssertionError(f"granite scale: err {err:.3g} / {err_d:.3g} > {bar}")
            worst = max(worst, err, err_d)
    log("kernels", f"granite attention at scale 1/128 (H=32, Hkv=8, D=128; flash S=64 and "
                   f"1024, B=1 and 8; decode over a 1032-slot ring): within TOL x max(|ref|, 1) "
                   f"(max abs err "
                   f"{worst:.3g}); the default scale bit-equal to 1/sqrt(D)")


def ring_tables(torch, p, W):
    """A decode step's ring positions and mask at W slots after ``p`` writes,
    with the self slot."""
    from repro_torch.models.kv_cache import ring_positions, ring_valid

    ones = torch.ones((p.shape[0], 1), dtype=torch.bool, device="cuda")
    return (torch.cat([ring_positions(p, W), p[:, None]], 1).contiguous(),
            torch.cat([ring_valid(p, W), ones], 1).contiguous())


# ---------------------------------------------------- phase 4: reduced parity
def run_teacher_forced(torch, params, cfg, tokens, teacher, window, patch_embeds=None,
                       frame_embeds=None):
    from repro_torch.models.model import forward_decode, forward_prefill

    logits, cache = forward_prefill(params, cfg, tokens, patch_embeds=patch_embeds,
                                    frame_embeds=frame_embeds, cache_window=window)
    out = [logits.float().cpu()]
    for t in teacher:
        logits, cache = forward_decode(params, cfg, t, cache)
        out.append(logits.float().cpu())
    return out


def expected_launches(cfg, prefills: int, decode_steps: int, prefill_tokens=()) -> dict:
    """Kernel launches a run of the model must make: each prefill launches
    flash attention once per attention layer and the SSD scan once per
    Mamba2 layer, each decode step decode attention once per attention
    layer (the SSD and conv decode steps are plain torch). Dense and moe
    models have an attention layer per layer, ssm models none, the hybrid
    one per application of its shared block: ceil(layers / attn_every).
    Every forward pass of a moe model launches the MoE matmul three times
    per layer (gate, up, down): the per-expert one, or, dropless, the
    grouped one for a prefill of more than 8 tokens (``prefill_tokens``,
    each prefill's B x S; the decode steps here are at batch 8 or less). A vlm is the dense model behind its patch
    prefix. An audio model's prefill also launches flash attention once
    per encoder layer (the prefill's cross-attention is plain: no kernel
    takes Sq != Skv), and each decode step decode attention twice per
    decoder layer (its ring, then the cached frames)."""
    from repro_torch.models.kv_cache import num_attn_layers, num_ssm_layers
    from repro_torch.models.moe import PADDED_DROPLESS_TOKENS

    L = cfg.num_layers
    attn, ssm = num_attn_layers(cfg), num_ssm_layers(cfg)
    moe = 3 * L if cfg.family in ("moe", "hybrid_moe") else 0
    audio = cfg.family == "audio"
    grouped = 0
    if moe and cfg.moe_capacity_factor is None:
        grouped = sum(t > PADDED_DROPLESS_TOKENS for t in prefill_tokens)
    return {"flash_attention": (attn + cfg.encoder_layers * audio) * prefills,
            "decode_attention": attn * (1 + audio) * decode_steps,
            "ssd_scan": ssm * prefills,
            "moe_gmm": moe * (prefills + decode_steps - grouped),
            "moe_gmm_grouped": moe * grouped}


class Routing:
    """Records every MoE layer call's expert ids and router probabilities
    while it is entered, by wrapping the port's router."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self._module, self._route = MOE, MOE.route

        def route(p, cfg, xt):
            probs, gates, ids = self._route(p, cfg, xt)
            self.calls.append((ids.cpu(), probs.detach().float().cpu(), cfg.experts_per_token))
            return probs, gates, ids

        MOE.route = route
        return self

    def __exit__(self, *exc):
        self._module.route = self._route

    def same_as(self, other, what):
        """Raise unless both runs routed every token alike; returns the
        smallest margin between the k-th and (k+1)-th router probability."""
        if len(self.calls) != len(other.calls) or not self.calls:
            raise AssertionError(f"{what}: {len(self.calls)} vs {len(other.calls)} MoE calls")
        gaps = []
        for n, ((ids, probs, k), (ids2, _, _)) in enumerate(zip(self.calls, other.calls)):
            top = probs.topk(k + 1, dim=-1).values
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
            if not ids.equal(ids2):
                raise AssertionError(f"{what}: expert ids differ at MoE call {n} (smallest "
                                     f"top-{k} router gap there {gaps[-1]:.3g})")
        return min(gaps)


def phase_reduced(torch):
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    # qwen: a 24-token prompt into windows of 128 and 16 (the ring wraps);
    # mamba2: two 64-token chunks, so the kernel carries a state across them;
    # zamba2: two chunks into windows of 128 and 16; mixtral and arctic as
    # qwen, in float32 so that the routing of both runs can be compared
    # (bf16 rounds the router's input differently); nemotron, codeqwen and
    # phi3 as qwen, internvl2 behind random patch embeddings; whisper-tiny
    # behind random frame embeddings, held in float32 (its bf16 gap is
    # recorded: see WHISPER_BF16)
    for arch, seq, windows, dtype in (
            ("qwen2.5-3b", 24, (128, 16), None), ("mamba2-1.3b", 128, (None,), None),
            ("zamba2-7b", 128, (128, 16), None),
            ("mixtral-8x7b", 24, (128, 16), "float32"),
            ("arctic-480b", 24, (128, 16), "float32"),
            ("nemotron-4-15b", 24, (128, 16), None), ("codeqwen1.5-7b", 24, (128, 16), None),
            ("phi3-mini-3.8b", 24, (128, 16), None), ("internvl2-76b", 24, (128, 16), None),
            ("whisper-tiny", 24, (128, 16), "float32"),
            ("whisper-tiny", 24, (128, 16), "bfloat16")):
        cfg = get_reduced_config(arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        recorded = cfg.family == "audio" and cfg.dtype == "bfloat16"
        cpu_params = init_params(torch.Generator().manual_seed(0), cfg)
        gpu_params = to(cpu_params, "cuda")
        rng = np.random.default_rng(0)
        toks = rng.integers(1, cfg.vocab_size, size=(2, seq)).astype(np.int32)
        teacher = rng.integers(1, cfg.vocab_size, size=(8, 2)).astype(np.int32)
        patches = (torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
            if cfg.family == "vlm" else None)
        frames = (torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(cfg.torch_dtype)
            if cfg.is_encoder_decoder else None)
        with torch.inference_mode():
            for window in windows:
                ops.reset_launch_counts()
                with Routing() as gpu_routing:
                    got = run_teacher_forced(torch, gpu_params, cfg,
                                             torch.from_numpy(toks).cuda(),
                                             [torch.from_numpy(t).cuda() for t in teacher],
                                             window, None if patches is None else patches.cuda(),
                                             None if frames is None else frames.cuda())
                counts = ops.launch_counts()
                with Routing() as cpu_routing:
                    want = run_teacher_forced(torch, cpu_params, cfg, torch.from_numpy(toks),
                                              [torch.from_numpy(t) for t in teacher], window,
                                              patches, frames)
                errs = [(float((a - b).abs().max()), float(b.abs().max()))
                        for a, b in zip(got, want)]
                rel = max(e / m for e, m in errs)
                expected = expected_launches(cfg, 1, len(teacher))
                if counts != expected:
                    raise AssertionError(f"reduced {cfg.name}: launches {counts} != {expected}")
                if not all(torch.isfinite(a).all() for a in got):
                    raise AssertionError(f"reduced {cfg.name}: non-finite logits")
                if cfg.dtype == "float32":
                    worst = max(e / (TOL["float32"] * max(m, 1.0)) for e, m in errs)
                    if worst > 1.0:
                        raise AssertionError(f"reduced {cfg.name} window={window}: logits "
                                             f"beyond TOL (x{worst:.3g} of the bar)")
                    verdict = (f"max abs err {max(e for e, _ in errs):.3g} within "
                               f"{TOL['float32']} x max(|ref|, 1)")
                    if cfg.family == "moe":
                        gap = gpu_routing.same_as(cpu_routing, f"reduced {cfg.name}")
                        verdict += (f"; expert ids equal in {len(cpu_routing.calls)} MoE "
                                    f"calls, smallest top-{cfg.experts_per_token} router gap "
                                    f"{gap:.3g}")
                elif recorded:
                    verdict = (f"max rel err {rel:.4g} (recorded, no bar: {WHISPER_BF16})")
                elif rel >= REDUCED_REL:
                    raise AssertionError(f"reduced {cfg.name} window={window}: rel err {rel} "
                                         f">= {REDUCED_REL}")
                else:
                    verdict = f"max rel err {rel:.4g} (< {REDUCED_REL})"
                prefix = f" behind {cfg.frontend_tokens} patches" if patches is not None else ""
                if frames is not None:
                    prefix = f", {cfg.encoder_seq} random frame embeddings"
                log("reduced", f"{cfg.name} {cfg.dtype} prompt {seq}{prefix} window={window}: "
                               f"prefill + {len(teacher)} teacher-forced decode steps, cuda "
                               f"(kernels) vs cpu (plain) logits {verdict}; launches {counts}")


# ------------------------------------------------------- phase 5: quickstart
def phase_quickstart(torch):
    """examples/quickstart_torch.py on the card and on the CPU: the engine
    runs reduced qwen, and the CSOAA agents size the 120-request stream;
    the three allocations printed after it must be equal on both devices."""
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    lines = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            quickstart.main(device=device)
        text = out.getvalue().splitlines()
        lines[device] = [line.strip() for line in text if "prompt=" in line]
        for line in text:
            if line.strip():
                log("quickstart", f"{device}: {line.strip()}")
    if len(lines["cuda"]) != 3 or lines["cuda"] != lines["cpu"]:
        raise AssertionError(f"quickstart: allocations on the card {lines['cuda']} != on the "
                             f"CPU {lines['cpu']}")
    log("quickstart", "the 3 allocations after the 120-request stream are equal on the card "
                      "and on the CPU")


# ---------------------------------------------------------- phase 6: serve
def widen_in_place(torch, params, layers):
    """The served weights, cut to their first ``layers`` layers and widened
    to float32 in the same dict: the stacked block leaves past the cut are
    freed first (each replaced by a copy of its kept layers), then every
    leaf is replaced by its float32 copy, blocks first. No bf16 leaf
    outlives its replacement, so the peak stays near the served model's."""
    def each(tree, fn):
        for k, v in tree.items():
            if isinstance(v, dict):
                each(v, fn)
            else:
                tree[k] = fn(v)

    if layers < len(next(leaves(params["blocks"]))):
        each(params["blocks"], lambda v: v[:layers].clone())
        torch.cuda.empty_cache()  # the freed layers go back to the card
    each(params["blocks"], lambda v: v.float())
    each(params, lambda v: v.float())


def full_width_f32_check(torch, engine, prompts, tokens):
    """The full-width kernel path against the plain path on the card, on
    the served weights widened to float32: both paths then differ only in
    summation order, and FULL_F32_REL leaves room for every layer of it.
    (In bf16 the plain attention rounds probabilities to bf16 before P.V
    and the kernel keeps them in fp32; over 36 layers that alone reaches
    about 0.02 of the largest logit, so bf16 is no test of the kernels.)
    The engine's weights are widened in place (widen_in_place) and the
    engine serves no more. A model is widened at its F32_LAYERS cut where
    it has one (all 16 layers of mixtral-8x7b-16l would take 94 GB in
    float32, 16 of internvl2-76b-40l's 40 take 63 GB) and whole otherwise
    (nemotron-4-15b: 62.5 GB), its unstacked shared block included; the
    peak must stay under F32_PEAK of the card. A moe model must route
    every token to the same experts on both paths; a vlm prefills random
    patch embeddings, an audio model encodes random frame embeddings.
    Each prompt is prefilled (padded as the engine pads
    it) and then fed 4 of the served tokens.
    Returns the largest relative logit error."""
    import dataclasses

    import numpy as np

    from repro_torch.models.model import forward_decode, forward_prefill

    cfg = engine.cfg
    layers = F32_LAYERS.get(cfg.name, cfg.num_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params32, engine.params = engine.params, None
    widen_in_place(torch, params32, layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
    patches = frames = None
    prefix = ""
    rng = np.random.default_rng(2)
    if cfg.family == "vlm":
        patches = torch.from_numpy(rng.standard_normal(
            (1, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).cuda()
        prefix = f", random patch_embeds {tuple(patches.shape)}"
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).cuda()
        prefix = f", random frame_embeds {tuple(frames.shape)}"
    rels = []
    with torch.inference_mode():
        for prompt in prompts:
            padded = engine._pad_batch([prompt])
            seqs, routing = {}, {}
            for use_kernels in (True, False):
                with Routing() as routing[use_kernels]:
                    logits, cache = forward_prefill(params32, cfg32, padded,
                                                    patch_embeds=patches, frame_embeds=frames,
                                                    cache_window=128,
                                                    use_kernels=use_kernels)
                    seq = [logits]
                    for t in tokens[:4]:
                        token = torch.tensor([t], dtype=torch.int32, device=padded.device)
                        logits, cache = forward_decode(params32, cfg32, token, cache,
                                                       use_kernels=use_kernels)
                        seq.append(logits)
                seqs[use_kernels] = seq
            for a, b in zip(seqs[True], seqs[False]):
                if not (a.shape == (1, cfg.vocab_size) and torch.isfinite(a).all()):
                    raise AssertionError("serve: non-finite or misshapen full-width logits")
                rels.append(float((a - b).abs().max()) / float(b.abs().max()))
            routed = ""
            if cfg.family == "moe":
                gap = routing[True].same_as(routing[False], f"{cfg.name} full width f32")
                routed = (f"; expert ids equal in {len(routing[True].calls)} MoE calls, "
                          f"smallest top-{cfg.experts_per_token} router gap {gap:.3g}")
            log("serve", f"{cfg.name} full width in float32 ({layers} of {cfg.num_layers} "
                         f"layers, {nbytes(params32) / 1e9:.1f} GB), prompt {len(prompt)} "
                         f"(padded to {padded.shape[1]}){prefix} + 4 decode steps, kernels vs "
                         f"plain on the card: logits max rel err {max(rels[-5:]):.3g} "
                         f"(< {FULL_F32_REL}){routed}")
    del params32
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log("serve", f"{cfg.name} float32 check: peak memory {peak / 1e9:.2f} GB = "
                 f"{100 * peak / total:.1f}% of the card's {total / 1e9:.1f} GB "
                 f"(bar {100 * F32_PEAK:.0f}%)")
    if peak >= F32_PEAK * total:
        raise AssertionError(f"serve: the float32 check peaked at {peak / 1e9:.2f} GB")
    if max(rels) >= FULL_F32_REL:
        raise AssertionError(f"serve: full-width f32 kernel vs plain rel err {max(rels)}")
    return max(rels)


def phase_f32(torch, engine, served):
    """The full-width float32 check of a served path (after its profile:
    it consumes the engine's weights)."""
    import numpy as np

    cfg = engine.cfg
    prompts = [served[0].prompt]
    if cfg.family in ("ssm", "hybrid"):
        # a prompt of two chunks, so the kernel carries the state across them
        rng = np.random.default_rng(1)
        prompts.append([int(t) for t in rng.integers(1, cfg.vocab_size, size=300)])
    full_width_f32_check(torch, engine, prompts, served[0].result.tokens[0])


def phase_refuse(torch, arch):
    """A config whose weights exceed the card is refused by the launcher
    before anything is allocated: device memory is unchanged."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        serve(get_config(arch), requests=1, device="cuda", log=lambda m: log("serve", m))
    except ValueError as exc:
        reason = str(exc)
    else:
        raise AssertionError(f"serve: {arch} was not refused")
    after = torch.cuda.memory_allocated()
    log("serve", f"{arch} refused before allocating (device memory {before / 1e9:.2f} GB "
                 f"before and {after / 1e9:.2f} GB after): {reason}")
    if after != before:
        raise AssertionError(f"serve: refusing {arch} allocated {after - before} bytes")


def phase_serve(torch, arch):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    cfg = get_config(arch)
    if arch in DROPLESS:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ops.reset_launch_counts()  # counts from here on are this path's
    engine, served = serve(cfg, requests=SERVE_REQUESTS, max_new=SERVE_MAX_NEW, seed=0,
                           device="cuda", log=lambda m: log("serve", m))
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = expected_launches(cfg, len(served), SERVE_MAX_NEW * len(served),
                                 [len(r.prompt) for r in served])
    widths = []
    if cfg.family != "ssm":
        widths.append(f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim {cfg.head_dim}, "
                      f"d_ff {cfg.d_ff} ({cfg.mlp_type}"
                      f"{', QKV bias' if cfg.qkv_bias else ''})")
    if cfg.family == "vlm":
        widths.append(f"{cfg.frontend_tokens} patch embeddings (zeros: no image) before "
                      f"the prompt")
    if cfg.is_encoder_decoder:
        widths.append(f"a {cfg.encoder_layers}-layer bidirectional encoder over "
                      f"{cfg.encoder_seq} frame embeddings (zeros: no audio), cross-attention "
                      f"in every decoder layer, learned positions (at most "
                      f"{cfg.max_target_positions} decoder positions), no RoPE")
    if cfg.family == "hybrid":
        widths.append(f"one shared attention block applied every {cfg.attn_every} layers "
                      f"({-(-cfg.num_layers // cfg.attn_every)} applications)")
    if cfg.family == "hybrid_moe":
        widths.append(f"{cfg.layer_types.count('mamba')} Mamba2 and "
                      f"{cfg.layer_types.count('attention')} attention layers (no RoPE, scale "
                      f"{cfg.attention_multiplier}), a shared expert of {cfg.shared_d_ff}, "
                      f"multipliers {cfg.embedding_multiplier} / {cfg.residual_multiplier} / "
                      f"1/{cfg.logits_scaling:g}")
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        widths.append(f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads x "
                      f"P={cfg.ssm_head_dim}, N={cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
                      f"conv {cfg.conv_width}")
    if cfg.family in ("moe", "hybrid_moe"):
        widths.append(f"{cfg.num_experts} experts top-{cfg.experts_per_token}, "
                      + ("dropless" if cfg.moe_capacity_factor is None else
                         f"capacity {cfg.moe_capacity_factor}")
                      + f", window {cfg.sliding_window}")
    log("serve", f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                 f"{'; '.join(widths)}, "
                 f"vocab {cfg.vocab_size}, {cfg.dtype}, "
                 f"{cfg.param_count() / 1e9:.3f} B params (random, seed 0)")
    if counts != expected:
        raise AssertionError(f"serve {cfg.name}: launches {counts} != expected {expected}")
    for rec in served:
        toks = rec.result.tokens[0]
        if len(toks) != SERVE_MAX_NEW or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"serve: bad tokens {toks}")
    prefill = [r.result.prefill_s * 1e3 for r in served]
    decode = [r.result.decode_s * 1e3 / SERVE_MAX_NEW for r in served]
    # the greedy tokens of every request, to compare one tree's serve with another's
    digest = hashlib.sha1(json.dumps([r.result.tokens for r in served]).encode()).hexdigest()
    log("serve", f"{cfg.name}: {len(served)} requests in {wall:.2f} s incl. weight init; peak "
                 f"memory {peak_gb:.2f} GB; prefill ms {[round(p, 2) for p in prefill]}; "
                 f"decode ms/step median {statistics.median(decode):.2f} (min "
                 f"{min(decode):.2f}, max {max(decode):.2f}); launches {counts} "
                 f"(expected {expected}); greedy tokens sha1 {digest[:16]}")
    return engine, served, counts


# --------------------------------------------------------- phase 7: profile
def phase_profile(torch, engine, prompt):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import ssm as SSM

    name = engine.cfg.name
    # the ssm and hybrid decode step's plain SSD and conv steps, as named ranges
    ranges = (("ssd_decode_step", "conv_decode_step")
              if engine.cfg.family in ("ssm", "hybrid") else ())
    originals = {r: getattr(SSM, r) for r in ranges}

    def named(label, fn):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)
    wall_ms = (time.perf_counter() - t0) * 1e3
    try:
        for r in ranges:
            setattr(SSM, r, named(r, originals[r]))
        # host ops are traced only where a named range needs them: tracing
        # them multiplies the trace and the time to read it
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
        with profile(activities=activities) as prof:
            traced = engine.generate([prompt], max_new_tokens=SERVE_MAX_NEW)
            torch.cuda.synchronize()
    finally:
        for r in ranges:
            setattr(SSM, r, originals[r])
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in ranges:
            tot, cnt = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    busy_ms = sum(t for t, _ in kernels.values())
    launches = sum(c for _, c in kernels.values())
    if busy_ms <= 0:
        raise AssertionError("profile: the trace holds no device time")
    share = busy_ms / wall_ms
    log("profile", f"{name}: 1 request, prompt {len(prompt)}, {SERVE_MAX_NEW} new tokens: "
                   f"untraced wall {wall_ms:.2f} ms (prefill {res.prefill_s * 1e3:.2f} ms, "
                   f"decode {res.decode_s * 1e3 / SERVE_MAX_NEW:.2f} ms/step); traced device "
                   f"time {busy_ms:.2f} ms = device busy {100 * share:.1f}% of the untraced "
                   f"wall; {launches} device kernels (~{launches / (SERVE_MAX_NEW + 1):.0f} "
                   f"per forward pass)")
    for kname, (t, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log("profile", f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% x{cnt:<5d} {kname[:90]}")
    passes = SERVE_MAX_NEW + 1
    layers = engine.cfg.num_layers
    log("profile", f"  {launches / (passes * layers):.1f} device kernels per layer per "
                   f"forward pass ({layers} layers, {passes} passes)")
    if engine.cfg.family == "moe":
        # the kernel and, where it splits D, its slice-sum kernel
        gmm_ms = sum(t for k, (t, _) in kernels.items() if "moe_gmm" in k)
        gmm_n = sum(c for k, (_, c) in kernels.items() if "moe_gmm" in k and "reduce" not in k)
        # a decode step at batch 1 reads every weight but the embedding table
        # (one row) and, of each layer's experts, only the experts_per_token
        # its token routes to (the others' products are 0 and are skipped)
        cfg = engine.cfg
        all_bytes = nbytes(engine.params) - nbytes({"embed": engine.params["embed"]})
        experts = engine.params["blocks"]["moe"]
        expert_bytes = sum(experts[k].numel() * experts[k].element_size()
                           for k in ("wg", "wu", "wd"))
        step_bytes = all_bytes - expert_bytes * (1 - cfg.experts_per_token / cfg.num_experts)
        log("profile", f"  moe_gmm: {gmm_ms:.3f} ms = {100 * gmm_ms / busy_ms:.1f}% of device "
                       f"time, {gmm_n} launches ({gmm_n / (passes * layers):.1f} per layer "
                       f"per pass, {gmm_ms / gmm_n:.4f} ms each with its slice sums); a decode "
                       f"step's weight-streaming bound (non-expert weights once, "
                       f"{cfg.experts_per_token} of {cfg.num_experts} experts a layer) "
                       f"{step_bytes / 1e9:.2f} GB / 3.35 TB/s = {step_bytes / MEM_BPS * 1e3:.2f} "
                       f"ms (every weight: {all_bytes / 1e9:.2f} GB, "
                       f"{all_bytes / MEM_BPS * 1e3:.2f} ms)")
    if engine.cfg.family == "hybrid":
        log("profile", "  " + hybrid_step_bound(engine))
    if engine.cfg.family in ("dense", "vlm"):
        log("profile", "  " + dense_step_bound(engine, len(prompt)))
    if engine.cfg.family == "audio":
        log("profile", "  " + audio_step_bound(engine, len(prompt)))
    step_ms = traced.decode_s * 1e3 / SERVE_MAX_NEW
    for r in ranges:
        evs = [e for e in prof.events() if e.name == r and e.device_type == DeviceType.CPU]
        dev = sum(e.device_time_total for e in evs) / 1e3 / SERVE_MAX_NEW
        host = sum(e.cpu_time_total for e in evs) / 1e3 / SERVE_MAX_NEW
        log("profile", f"  decode step share of {r} (plain torch, {len(evs)} calls): host "
                       f"{host:.3f} ms/step = {100 * host / step_ms:.1f}% of the traced "
                       f"{step_ms:.2f} ms/step; device {dev:.3f} ms/step")
    log("profile", "nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
                   + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def nbytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in leaves(tree))


def dense_step_bound(engine, prompt_len: int) -> str:
    """A dense (or vlm) decode step's weight-streaming bound at batch 1:
    every weight once but the embedding table (one row), and the K/V of
    the live ring slots at the request's last step (the prompt, a vlm's
    patch prefix and the tokens decoded before it, at most the window,
    plus the self slot) in every layer."""
    cfg, p = engine.cfg, engine.params
    weights = nbytes(p) - nbytes({"embed": p["embed"]})
    last = cfg.frontend_tokens + prompt_len + SERVE_MAX_NEW - 1
    live = min(last, engine.cache_window) + 1
    kv = cfg.num_layers * 2 * live * cfg.num_kv_heads * cfg.head_dim * cfg.torch_dtype.itemsize
    total = weights + kv
    return (f"decode step's weight-streaming bound: weights but the embedding table "
            f"{weights / 1e9:.2f} GB + K/V of {live} live slots x {cfg.num_layers} layers "
            f"{kv / 1e9:.4f} GB = {total / 1e9:.2f} GB / 3.35 TB/s = "
            f"{total / MEM_BPS * 1e3:.2f} ms")


def audio_step_bound(engine, prompt_len: int) -> str:
    """An audio (whisper) decode step's bound at batch 1: the decoder's
    weights but its cross-attention's K/V projections (the frames' K/V are
    cached at prefill), the final norm and lm_head, the K/V of the live
    ring slots, and the cached cross K/V of every frame, read whole by
    each layer. The encoder, ``enc_pos`` and the embedding tables give
    nothing (one row each of ``embed`` and ``dec_pos``)."""
    cfg, p = engine.cfg, engine.params
    xattn = p["blocks"]["xattn"]
    weights = (nbytes(p["blocks"]) - nbytes({k: xattn[k] for k in ("wk", "wv")})
               + nbytes({k: p[k] for k in ("final_norm", "lm_head")}))
    itemsize = cfg.torch_dtype.itemsize
    live = min(prompt_len + SERVE_MAX_NEW - 1, engine.cache_window) + 1
    kv = cfg.num_layers * 2 * live * cfg.num_kv_heads * cfg.head_dim * itemsize
    cross = cfg.num_layers * 2 * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim * itemsize
    total = weights + kv + cross
    return (f"decode step's bound: decoder weights but the cross K/V projections, and the "
            f"lm_head {weights / 1e6:.2f} MB + K/V of {live} live slots x {cfg.num_layers} "
            f"layers {kv / 1e6:.3f} MB + cross K/V of {cfg.encoder_seq} frames x "
            f"{cfg.num_layers} layers {cross / 1e6:.2f} MB = {total / 1e6:.2f} MB / "
            f"3.35 TB/s = {total / MEM_BPS * 1e3:.4f} ms (the encoder, "
            f"{nbytes(p['encoder']) / 1e6:.2f} MB, runs once a prefill)")


def hybrid_step_bound(engine) -> str:
    """A hybrid decode step's weight-streaming bound at batch 1: the shared
    block's weights at each of its applications, every Mamba2 layer's
    weights once, the final norm and lm_head, the SSD states and conv
    windows read and written, the full 128-slot ring of K/V read at each
    application (served prompts pad to 256 tokens). The embedding table
    gives one row."""
    cfg, p = engine.cfg, engine.params
    apps = -(-cfg.num_layers // cfg.attn_every)
    itemsize = cfg.torch_dtype.itemsize
    shared, layers = nbytes(p["shared_attn"]), nbytes(p["blocks"])
    head = nbytes({k: p[k] for k in ("final_norm", "lm_head")})
    states = 2 * cfg.num_layers * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                                   + (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
                                   * itemsize)
    kv = apps * 2 * engine.cache_window * cfg.num_kv_heads * cfg.head_dim * itemsize
    total = apps * shared + layers + head + states + kv
    return (f"decode step's weight-streaming bound: shared block {shared / 1e9:.3f} GB x "
            f"{apps} applications ({apps * shared / 1e9:.2f} GB) + {cfg.num_layers} Mamba2 "
            f"layers {layers / 1e9:.2f} GB + final norm and lm_head {head / 1e9:.2f} GB + "
            f"SSD and conv states read and written {states / 1e9:.2f} GB + K/V ring read "
            f"{kv / 1e9:.3f} GB = {total / 1e9:.2f} GB / 3.35 TB/s = "
            f"{total / MEM_BPS * 1e3:.2f} ms")


# ------------------------------------------------------------ phase 8: shapes
# qwen2.5-3b at its published width and depth (36 layers) through
# repro_torch.launch.steps at the reference's four assigned shapes; the one-card
# cut is the batch alone (label, shape at the one-card batch, timed steps):
# prefill_32k at 1 of 32 sequences, decode_32k at 32 of 128, long_500k at its
# 1, train_4k at 1 of 256, and the long-context prefill behind long_500k at
# LONG_PREFILL tokens (twice its 8192-slot window, so the ring wraps)
LONG_PREFILL = 16_384
PLAN_REL = 0.02  # measured memory_allocated against the dry run's plan
QTILE = 1024  # the plain path's query tile at these lengths (set_attn_qtile)
SHAPES_ARCH = "qwen2.5-3b"


def shape_cases():
    import dataclasses

    from repro_torch.configs import DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K

    one = dataclasses.replace
    return [("prefill_32k", one(PREFILL_32K, global_batch=1), 3),
            ("long_500k prefill", one(LONG_500K, seq_len=LONG_PREFILL, kind="prefill"), 3),
            ("long_500k", LONG_500K, 3),
            ("decode_32k", one(DECODE_32K, global_batch=32), 3),
            ("train_4k", one(TRAIN_4K, global_batch=1), 2)]


def library_ms(torch, fn, what, **kw):
    """The yardstick's time, or None where no fused backend takes the call
    (the math backend would hold the whole score matrix)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return time_ms(torch, fn, **kw)
    except RuntimeError as exc:
        log("shapes", f"  {what}: no fused sdpa backend takes it ({str(exc)[:120]})")
        return None


def long_flash_case(torch, F, fa, S, window):
    """flash_attention at qwen's widths (B=1, H=16, Hkv=2, D=128, bf16,
    causal) over S positions, against the plain version over query tiles of
    QTILE rows (the whole (H, S, S) float32 score matrix would take 68.7 GB at
    S = 32768), within TOL and row by row. The yardstick is sdpa over K/V
    repeated to the 16 q heads (the repeat is not timed)."""
    from repro_torch.launch.dryrun import live_pairs
    from repro_torch.models import layers as L

    q, k, v = flash_inputs(torch, 1, S, 16, 2, 128, torch.bfloat16, seed=S + (window or 0))
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = L.sdpa_qtiled(q, k, v, causal=True, window=window, q_tile=QTILE)
    torch.cuda.synchronize()
    err, scale = max_err(torch, got, want)
    what = f"flash_attention shapes B=1 S={S} H=16 Hkv=2 D=128 bf16 causal window={window}"
    if not (got.shape == want.shape and err <= TOL["bfloat16"] * scale):
        raise AssertionError(f"{what}: err {err} > {TOL['bfloat16'] * scale}")
    check_rows("flash", got, want, what)
    del got, want
    flops = 4 * 16 * 128 * live_pairs(S, True, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(8, dim=2).transpose(1, 2) for t in (k, v))
    mask = None
    if window is not None:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    rec = {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True, window=window),
                      iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: L.sdpa_qtiled(q, k, v, causal=True, window=window,
                                                         q_tile=QTILE), iters=1, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None), what, iters=10, warmup=2),
        "body": flash_body(fa, q, k),
    }
    log("shapes", f"{what}: {fmt(rec)}")
    return rec


def shapes_kernels(torch):
    """Both attention kernels at the shapes' lengths: flash at prefill_32k's
    S = 32768 and at the long-context prefill's S = 16384 with its 8192
    window; decode at decode_32k's W + 1 = 32769 slots for 32 sequences
    and at long_500k's 8193 slots at position 524287."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    recs = {("flash", 32768): long_flash_case(torch, F, fa, 32768, None),
            ("flash", LONG_PREFILL): long_flash_case(torch, F, fa, LONG_PREFILL, 8192)}
    torch.cuda.empty_cache()
    for B, W, pos in ((32, 32769, 32768), (1, 8193, 524287)):
        _, rec = decode_case(torch, F, da, ref, B, W, 2, 8, 128, "bfloat16", [pos] * B,
                             timed=True)
        recs[("decode", W)] = rec
        log("shapes", f"decode_attention shapes B={B} W={W} H=16 Hkv=2 D=128 bf16 pos={pos} "
                      f"(every slot live): {fmt(rec)}")
        torch.cuda.empty_cache()
    return recs


def shapes_f32_check(torch):
    """The kernel path against the plain path in float32 at qwen's full width
    and 2 of its 36 layers (the plain path over query tiles of QTILE rows):
    a decode_32k serve step for 2 sequences over a seeded 32768-slot cache
    at position 32767, and a long-context prefill of LONG_PREFILL tokens
    (the 8192-slot ring wraps) followed by 4 decode steps. Logits within
    FULL_F32_REL of the largest, the rings after the steps too."""
    import dataclasses

    from repro_torch.configs import DECODE_32K, LONG_500K, get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import layers as L
    from repro_torch.models.kv_cache import init_cache
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config(SHAPES_ARCH), dtype="float32", num_layers=2)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rels = {}

    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("shapes: non-finite float32 logits")
        return float((a - b).abs().max()) / float(b.abs().max())

    with torch.inference_mode():
        cache = init_cache(cfg, DECODE_32K, batch=2, device="cuda", generator=gen)
        cache["pos"].fill_(DECODE_32K.seq_len - 1)
        token = torch.randint(1, cfg.vocab_size, (2,), generator=gen, dtype=torch.int32,
                              device="cuda")
        outs = {}
        for use_kernels in (True, False):
            step_cache = {k: v.clone() for k, v in cache.items()}
            outs[use_kernels], step_cache = make_serve_step(cfg, use_kernels)(
                params, step_cache, token)
            outs[use_kernels, "k"] = step_cache["k"]
        rels["decode_32k step"] = rel(outs[True], outs[False])
        rels["decode_32k ring"] = rel(outs[True, "k"], outs[False, "k"])
        del cache, outs, step_cache
        shape = dataclasses.replace(LONG_500K, seq_len=LONG_PREFILL, kind="prefill")
        tokens = torch.randint(1, cfg.vocab_size, (1, LONG_PREFILL), generator=gen,
                               dtype=torch.int32, device="cuda")
        teacher = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen, dtype=torch.int32,
                                device="cuda")
        seqs, rings = {}, {}
        for use_kernels in (True, False):
            L.set_attn_qtile(0 if use_kernels else QTILE)
            try:
                logits, cache = make_prefill_step(cfg, shape, use_kernels)(
                    params, {"tokens": tokens})
                seqs[use_kernels] = [logits.clone()]
                del logits  # a view of the whole (1, S, V) logits
                for t in teacher:
                    logits, cache = make_serve_step(cfg, use_kernels)(params, cache, t)
                    seqs[use_kernels].append(logits)
            finally:
                L.set_attn_qtile(0)
            rings[use_kernels] = cache["k"]
            if cache["k"].shape[2] != 8192 or int(cache["pos"][0]) != LONG_PREFILL + 4:
                raise AssertionError(f"shapes: long-context cache {tuple(cache['k'].shape)} "
                                     f"at {cache['pos'].tolist()}")
            del cache
        for i, (a, b) in enumerate(zip(seqs[True], seqs[False])):
            rels[f"long-context {'prefill' if i == 0 else f'decode {i}'}"] = rel(a, b)
        rels["long-context ring"] = rel(rings[True], rings[False])
    del params, seqs, rings
    torch.cuda.empty_cache()
    worst = max(rels.values())
    log("shapes", f"{SHAPES_ARCH} float32, full width, 2 of 36 layers, kernels vs plain (plain "
                  f"over {QTILE}-row query tiles): " + "; ".join(
                      f"{k} {v:.3g}" for k, v in rels.items()) + f" (bar {FULL_F32_REL})")
    if not worst < FULL_F32_REL:
        raise AssertionError(f"shapes: float32 kernel vs plain rel err {worst}")


def profile_first(torch, traces: list):
    """For ``patched``: the step factory's first step (``measure``'s
    untimed warm-up) runs under the profiler, whose trace goes to
    ``traces``; the timed steps run as they are."""
    from torch.profiler import ProfilerActivity, profile

    def make(factory):
        def wrapped_factory(*args, **kwargs):
            step, n = factory(*args, **kwargs), [0]

            def run(*a, **kw):
                n[0] += 1
                if n[0] > 1:
                    return step(*a, **kw)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    out = step(*a, **kw)
                    torch.cuda.synchronize()
                traces.append(prof)
                return out
            return run
        return wrapped_factory
    return make


def concat_share(prof, label: str, name_power: str) -> None:
    """Device time of one profiled step by kernel, and the share of the
    concat mode's torch.cat of the window (its copy kernels)."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError(f"shapes {label}: the profiled step holds no device time")
    cat = sum(t for k, t in by_name.items() if "cat" in k.lower())
    log("shapes", f"{label}, profiled warm-up step: device busy {busy:.3f} ms; torch.cat of the "
                  f"window (concat mode) {cat:.3f} ms = {100 * cat / busy:.1f}% of it | "
                  f"{name_power}")
    for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log("shapes", f"  {t:9.3f} ms {100 * t / busy:5.1f}% {kname[:90]}")


def phase_shapes(torch, name_power: str) -> dict:
    """The reference's four assigned shapes at qwen2.5-3b's full width and
    depth on one card, through the dry run's plan and its ``measure``.
    Returns the kernel launches of the timed steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import one_gpu_mesh
    from repro_torch.models.model import init_params

    t0 = time.perf_counter()
    shapes_kernels(torch)
    t1 = time.perf_counter()
    shapes_f32_check(torch)
    t2 = time.perf_counter()
    cfg = get_config(SHAPES_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    counts = dict.fromkeys(ops.launch_counts(), 0)
    for label, shape, steps in shape_cases():
        plan = D.plan(cfg, shape, one_gpu_mesh())
        cost = D.step_cost(cfg, shape)
        rf = D.roofline(cfg, shape, cost)
        fl = D.floor(cfg, shape, plan, cost)
        traces = []
        with (patched(D, "make_serve_step", profile_first(torch, traces))
              if label == "decode_32k" else contextlib.nullcontext()):
            run = D.measure(cfg, shape, params, steps=steps, base_bytes=base)
        if traces:
            concat_share(traces[0], label, name_power)
        total = plan["total_bytes"]
        off = (run["resident_bytes"] - total) / total
        log("shapes", f"{label} ({shape.kind}, S={shape.seq_len}, B={shape.global_batch}): "
                      f"plan params {plan['params_bytes'] / 1e9:.3f} + optimizer "
                      f"{plan['opt_state_bytes'] / 1e9:.3f} + cache "
                      f"{plan['cache_bytes'] / 1e9:.3f} + inputs {plan['input_bytes'] / 1e9:.6f}"
                      f" = {total / 1e9:.3f} GB; memory_allocated {run['resident_bytes'] / 1e9:.3f}"
                      f" GB ({100 * off:+.3f}%, bar {100 * PLAN_REL:.0f}%); peak "
                      f"{run['peak_bytes'] / 1e9:.2f} GB")
        log("shapes", f"{label}: step ms {[round(x, 3) for x in run['step_ms']]}, median "
                      f"{run['median_ms']:.3f} ms = {run['tokens_per_s']:,.1f} tokens/s = "
                      f"{fl['bound_s'] * 1e3 / run['median_ms']:.4f} of its floor "
                      f"{fl['bound_s'] * 1e3:.3f} ms (by {fl['by']}: {fl['flops'] / 1e12:.3f} "
                      f"TFLOP: {fl['compute_s'] * 1e3:.3f} ms, {fl['bytes'] / 1e9:.3f} GB moved "
                      f"once: {fl['memory_s'] * 1e3:.3f} ms); eager traffic of the step as "
                      f"written {max(rf['compute_s'], rf['memory_s']) * 1e3:.3f} ms "
                      f"({cost['flops'] / 1e12:.3f} TFLOP: {rf['compute_s'] * 1e3:.3f} ms, "
                      f"{cost['bytes'] / 1e9:.2f} GB: {rf['memory_s'] * 1e3:.3f} ms); "
                      f"launches per step {run['launches_per_step']} | {name_power}")
        if abs(off) > PLAN_REL:
            raise AssertionError(f"shapes {label}: memory_allocated {run['resident_bytes']} "
                                 f"is {100 * off:.2f}% off the plan's {total}")
        want = dict.fromkeys(counts, 0)
        if shape.kind != "train":
            want["flash_attention" if shape.kind == "prefill" else "decode_attention"] = (
                cfg.num_layers * steps)
        if run["launches"] != want:
            raise AssertionError(f"shapes {label}: launches {run['launches']} != {want}")
        for k in counts:
            counts[k] += run["launches"][k]
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    log("shapes", f"phase took {time.perf_counter() - t0:.1f} s (kernels {t1 - t0:.1f}, "
                  f"float32 check {t2 - t1:.1f}, the shapes {time.perf_counter() - t2:.1f})")
    return counts


# ------------------------------------------------------------ phase 9: train
TRAIN_PARITY_STEPS = 3
TRAIN_LOSS_REL = 1e-5  # tests/test_torch_training.py LOOP_REL
TRAIN_CLI_STEPS = 100  # launch/train.py checkpoints at max(steps // 2, 50)
# full-width qwen2.5-3b: batch, sequence, steps (bf16 params, float32 moments)
TRAIN_FULL = (4, 512, 5)


def quiet(tag, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its printed lines logged under ``tag``;
    returns (result, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    secs = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log("train", f"{tag}: {line.strip()}")
    return result, secs


def train_card_vs_cpu(torch, tmp: Path):
    """Reduced qwen2.5-3b, mixtral and whisper-tiny (random frame
    embeddings, the same array on both devices) in float32, resumed on the
    card and on the CPU from one step-0 checkpoint: every step's loss and
    grad norm within TRAIN_LOSS_REL, mixtral's expert ids equal."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import TrainLoopConfig, train

    for arch in ("qwen2.5-3b", "mixtral-8x7b", "whisper-tiny"):
        cfg = dataclasses.replace(get_reduced_config(arch), dtype="float32")
        extra = None
        if cfg.is_encoder_decoder:
            frames = np.random.default_rng(5).standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)

            def extra(step):
                return {"frame_embeds": frames}
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_PARITY_STEPS)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        start = tmp / f"{arch}-step0.msgpack"
        save_checkpoint(str(start), step=0, params=params, opt_state=init_opt_state(opt, params))
        runs, routing = {}, {}
        for device in ("cuda", "cpu"):
            with Routing() as routing[device]:
                runs[device], secs = quiet(
                    f"{cfg.name} {device}", train, cfg,
                    data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=2,
                                        seed=3),
                    opt_cfg=opt, loop=TrainLoopConfig(steps=TRAIN_PARITY_STEPS, log_every=1),
                    resume_from=str(start), extra_batch_fn=extra, device=device)
        card, cpu = runs["cuda"], runs["cpu"]
        rel = max(abs(a - b) / abs(b) for key in ("loss", "grad_norm")
                  for a, b in zip(card[key], cpu[key]))
        if card["step"] != cpu["step"] or len(card["step"]) != TRAIN_PARITY_STEPS:
            raise AssertionError(f"train {cfg.name}: steps {card['step']} vs {cpu['step']}")
        if not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"train {cfg.name}: card vs CPU losses / grad norms differ by "
                                 f"{rel:.3g} relative (bar {TRAIN_LOSS_REL}): card "
                                 f"{card['loss']}, CPU {cpu['loss']}")
        routed = ""
        if cfg.family == "moe":
            gap = routing["cuda"].same_as(routing["cpu"], f"train {cfg.name}")
            routed = (f"; expert ids equal in {len(routing['cpu'].calls)} MoE calls, smallest "
                      f"top-{cfg.experts_per_token} router gap {gap:.3g}")
        fed = " (random frame embeddings)" if extra is not None else ""
        log("train", f"{cfg.name} float32{fed}, {TRAIN_PARITY_STEPS} steps from one step-0 "
                     f"checkpoint, card vs CPU: losses {[round(x, 6) for x in card['loss']]}, "
                     f"worst loss / grad norm difference {rel:.3g} relative (bar "
                     f"{TRAIN_LOSS_REL}){routed}")


def train_cli_resume(tmp: Path):
    """launch/train.py on the card at reduced size: a run that checkpoints
    at step 50, and a run resumed from that checkpoint; from there their
    histories must be equal."""
    from repro_torch.launch import train as train_cli

    ckpts = tmp / "cli"
    args = ["--steps", str(TRAIN_CLI_STEPS), "--device", "cuda"]
    whole, secs = quiet("cli", train_cli.main, args + ["--ckpt-dir", str(ckpts)])
    mid = ckpts / f"ckpt_{TRAIN_CLI_STEPS // 2:06d}.msgpack"
    resumed, secs2 = quiet("cli resumed", train_cli.main, args + ["--resume", str(mid)])
    if not whole["loss"][-1] < whole["loss"][0]:
        raise AssertionError(f"train cli: the loss did not fall: {whole['loss']}")
    keep = [i for i, s in enumerate(whole["step"]) if s in resumed["step"]]
    same = {key: [whole[key][i] for i in keep] == [resumed[key][resumed["step"].index(
        whole["step"][i])] for i in keep] for key in ("loss", "grad_norm")}
    if len(keep) < 2 or not all(same.values()):
        raise AssertionError(f"train cli: the resumed history differs from the whole run's "
                             f"({same}): {whole} vs {resumed}")
    log("train", f"cli: reduced qwen2.5-3b, {TRAIN_CLI_STEPS} steps in {secs:.1f} s "
                 f"(loss {whole['loss'][0]:.4f} -> {whole['loss'][-1]:.4f}); resumed from "
                 f"{mid.name} in {secs2:.1f} s: losses and grad norms equal to the whole "
                 f"run's at steps {[whole['step'][i] for i in keep]}")


def train_full_width(torch, name_power: str):
    """Full-width qwen2.5-3b through train(): each step's time from CUDA
    events around train_step and, inside it, around adamw_update; the last
    step also under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.training import train_loop
    from repro_torch.training.data import DataConfig

    batch, seq, steps = TRAIN_FULL
    cfg = get_config("qwen2.5-3b")
    events, opt_events, prof = [], [], []

    def opt_timed(update):
        def wrapper(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = update(*args, **kwargs)
            end.record()
            opt_events.append((start, end))
            return out
        return wrapper

    def timed(step_fn):
        def wrapper(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            last = len(events) == steps - 1
            with (profile(activities=[ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as p:
                start.record()
                out = step_fn(*args, **kwargs)
                end.record()
                torch.cuda.synchronize()
            events.append((start, end))
            if last:
                prof.append(p)
            return out
        return wrapper

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with patched(train_loop, "train_step", timed), \
            patched(train_loop, "adamw_update", opt_timed):
        hist, secs = quiet("qwen2.5-3b full", train_loop.train, cfg,
                           data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                               batch_size=batch, seed=0),
                           loop=train_loop.TrainLoopConfig(steps=steps, log_every=1),
                           device="cuda")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in events]
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    if len(step_ms) != steps or not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"train full width: {len(step_ms)} steps, losses {hist['loss']}")
    # steps 2 to steps-1: past the first step's warm-up, before the profiled one
    warm = statistics.median(step_ms[1:-1])
    kernels = [e for e in prof[0].events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("train full width: the profiled step holds no device time")
    resident = sum(p.numel() for p in leaves(hist["final_params"]))
    flops = 6 * (resident - cfg.vocab_size * cfg.d_model) * batch * seq
    log("train", f"qwen2.5-3b full width ({resident / 1e9:.3f} B params, bf16, float32 "
                 f"moments), B={batch} S={seq}, {steps} steps in {secs:.1f} s incl. init: "
                 f"losses {[round(x, 4) for x in hist['loss']]}")
    wall_ms = [batch * seq / t * 1e3 for t in hist["tokens_per_s"]]
    log("train", f"qwen2.5-3b full width: step ms (CUDA events around train_step) "
                 f"{[round(x, 2) for x in step_ms]}; median of steps 2-{steps - 1} {warm:.2f} ms = "
                 f"{batch * seq / warm * 1e3:,.0f} tokens/s; the loop's wall ms per step "
                 f"(train_step and the host's data pipeline) "
                 f"{[round(x, 1) for x in wall_ms]} = "
                 f"{batch * seq / statistics.median(wall_ms[1:-1]) * 1e3:,.0f} tokens/s; peak "
                 f"torch.cuda.max_memory_allocated {peak_gb:.2f} GB; "
                 f"6 x matmul params x "
                 f"tokens = {flops / 1e12:.1f} TFLOP = {flops / (warm / 1e3) / 1e12:.0f} TFLOP/s "
                 f"({100 * flops / (warm / 1e3) / PEAK_FLOPS['bfloat16']:.1f}% of 989) | "
                 f"{name_power}")
    opt_warm = statistics.median(opt_ms[1:-1])
    log("train", f"qwen2.5-3b full width: adamw_update ms (CUDA events) "
                 f"{[round(x, 2) for x in opt_ms]}; median of steps 2-{steps - 1} "
                 f"{opt_warm:.2f} ms = {100 * opt_warm / warm:.1f}% of the step; the rest "
                 f"(forward, backward, grad buffers) {warm - opt_warm:.2f} ms | {name_power}")
    log("train", f"qwen2.5-3b full width, profiled step {steps}: {step_ms[-1]:.2f} ms, "
                 f"{len(kernels)} device kernels, device busy {busy_ms:.2f} ms = "
                 f"{100 * busy_ms / step_ms[-1]:.1f}% of the step | {name_power}")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    for kname, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log("train", f"  {t:9.3f} ms {100 * t / busy_ms:5.1f}% {kname[:90]}")


def phase_train(torch, name_power: str):
    """The port's training path on the card (no kernel: training runs the
    plain path, as the reference's does)."""
    import tempfile

    from repro_torch.kernels import ops

    before = ops.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_card_vs_cpu(torch, Path(tmp))
        t1 = time.perf_counter()
        train_cli_resume(Path(tmp))
        t2 = time.perf_counter()
    train_full_width(torch, name_power)
    t3 = time.perf_counter()
    if ops.launch_counts() != before:
        raise AssertionError(f"train: kernels launched: {before} -> {ops.launch_counts()}")
    log("train", f"launch counts unchanged across the phase ({before}); card vs CPU "
                 f"{t1 - t0:.1f} s, cli "
                 f"{t2 - t1:.1f} s, full width {t3 - t2:.1f} s")


# ------------------------------------------------------ phase 10: simulator
# One Azure day at sim_bench's quick tier (benchmarks/sim_bench.py:219-235,
# copied as literals): a 160-worker fleet (10 clusters x 16 workers) with
# queue-mode admission, fed 100k invocations per 8640 s (a tenth of a day;
# azure-24h compresses one diurnal cycle into the trace's window). The
# backlog is cut from sim_bench's 100k to SIM_SCALE_N at the same rate (a
# shorter window): with the agents on an H100 the 100k run took 172.64 s
# and 195.39 s, and 80k 153.51-196.2 s, more than this phase can take now
# that the script serves eight models.
SIM_RATE = 100_000 / 8_640.0
SIM_SCALE_N = 60_000
SIM_EQUAL_N = 10_000  # the card-vs-CPU run of the same config (864 s)
SIM_PROFILE_N = 2_000  # the profiled prefix of the trace
SIM_TIMED = ("allocate_batch", "allocate", "feedback", "flush")


def sim_scale_spec(n: int):
    from repro_torch.serving.workload import ScenarioSpec

    return ScenarioSpec("azure-24h", rps=SIM_RATE, duration_s=n / SIM_RATE, seed=11)


def sim_scale_config():
    from repro_torch.serving.simulator import SimConfig

    return SimConfig(seed=0, n_clusters=10, n_workers=16, admission="queue",
                     admission_headroom=0.85, queue_timeout_s=90.0,
                     retry_interval_s=0.5)


def sim_inputs(spec):
    """What run_scenario builds before its policy: profiles, the fixed
    input pool, the 1.4x SLO table and the scenario's trace."""
    from repro_torch.serving import baselines as B
    from repro_torch.serving.profiles import build_input_pool, build_profiles
    from repro_torch.serving.workload import generate_scenario

    profiles = build_profiles()
    pool = build_input_pool(seed=0)
    slo_table = B.build_slo_table(profiles, pool, multiplier=1.4)
    trace = generate_scenario(spec, functions=sorted(profiles),
                              inputs_per_function={f: len(pool[f]) for f in profiles})
    return profiles, pool, slo_table, trace


def sim_run(inputs, trace, device):
    """The shabari policy over ``trace`` on the scale fleet: (simulator,
    summary, wall seconds of sim.run)."""
    from repro_torch.serving.experiment import make_policy
    from repro_torch.serving.simulator import Simulator, summarize

    profiles, pool, slo_table, _ = inputs
    policy = make_policy("shabari", profiles, pool, slo_table, seed=0, device=device)
    sim = Simulator(policy=policy, profiles=profiles, input_pool=pool,
                    slo_table=slo_table, cfg=sim_scale_config())
    t0 = time.perf_counter()
    results = sim.run(trace)
    return sim, summarize(results), time.perf_counter() - t0


def agent_tensors(allocator):
    """Every weight / AdaGrad tensor of an allocator's CSOAA agents."""
    allocator = getattr(allocator, "inner", allocator)  # a FormulationAllocator
    if allocator._arena is not None:
        for ar in allocator._arena._arenas.values():
            yield from (ar.w, ar.g2)
    for ag in allocator._agents.values():
        yield from (ag.vcpu.w, ag.vcpu.g2, ag.mem.w, ag.mem.g2)


@contextlib.contextmanager
def patched(owner, name, make):
    """Replace ``owner.name`` by ``make(original)`` for the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


class AllocationRecord:
    """Every allocation the Shabari policy serves, in order, as
    ``(invocation id, function, vcpus, mem_mb)``, and for each arena
    predict the gap between its two cheapest classes per agent: what a
    golden mismatch is traced back with."""

    def __init__(self):
        self.served, self.gaps, self._iids = [], {}, []

    @contextlib.contextmanager
    def on(self):
        import torch

        from repro_torch.core import agent_arena as AA
        from repro_torch.serving import baselines as B

        rec = self

        def batch(orig):
            def wrapper(policy, items, sim):
                rec._iids = [a.invocation_id for a, _ in items]
                return orig(policy, items, sim)
            return wrapper

        def single(orig):
            def wrapper(policy, arrival, meta, sim, aux=None):
                rec._iids = [arrival.invocation_id]
                alloc, aux = orig(policy, arrival, meta, sim, aux)
                rec.served.append((arrival.invocation_id, arrival.function,
                                   alloc.vcpus, alloc.mem_mb))
                return alloc, aux
            return wrapper

        def predict(orig):
            def wrapper(engine, items):
                out = orig(engine, items)
                for iid, (fn, x, want_v, want_m) in zip(rec._iids, items):
                    xb = torch.cat([torch.as_tensor(x, dtype=torch.float32),
                                    torch.ones(1)]).to(engine.device)
                    gaps = []
                    for want, n in ((want_v, engine.n_vcpu_classes),
                                    (want_m, engine.n_mem_classes)):
                        if not want:  # no agent predicted (below confidence)
                            gaps.append(None)
                            continue
                        ar = engine._arena(n, len(x))
                        costs = AA._matvec(ar.w[ar.slot(fn)], xb).sort().values
                        gaps.append(float(costs[1] - costs[0]))
                    rec.gaps[iid] = tuple(gaps)
                return out
            return wrapper

        with patched(B.ShabariPolicy, "begin_arrival_batch", batch), \
                patched(B.ShabariPolicy, "allocate_with_aux", single), \
                patched(AA.ArenaEngine, "predict_batch", predict):
            yield self


def first_divergence(scenario, flags):
    """Rerun a golden on the card and on the CPU with every allocation
    recorded, and describe the first that differs."""
    from repro_torch.serving.golden import run_golden

    recs = {}
    for device in ("cuda", "cpu"):
        with AllocationRecord().on() as rec:
            run_golden(scenario, device=device, **flags)
        recs[device] = rec
    card, cpu = recs["cuda"], recs["cpu"]
    def said(rec, a):
        iid, fn, vcpus, mem_mb = a
        return (f"invocation {iid} ({fn}) vCPU class {vcpus - 1}, mem class "
                f"{mem_mb // 128 - 1}, top-2 cost gap (vCPU, mem) {rec.gaps.get(iid)}")

    for a, b in zip(card.served, cpu.served):
        if a != b:
            return (f"first differing allocation: card {said(card, a)}; "
                    f"CPU {said(cpu, b)}")
    return (f"all {min(len(card.served), len(cpu.served))} allocations equal on the card and "
            f"the CPU ({len(card.served)} vs {len(cpu.served)} served)")


def sim_goldens():
    """All 22 committed snapshots with the agents on the card, exactly."""
    from repro_torch.serving import experiment as E
    from repro_torch.serving.golden import golden_cases, run_golden

    policies = []

    def keep(orig):
        def wrapper(*args, **kwargs):
            policies.append(orig(*args, **kwargs))
            return policies[-1]
        return wrapper

    failed = []
    for path, (scenario, flags) in golden_cases().items():
        want = json.loads((ROOT / "tests" / "goldens" / path).read_text())["summary"]
        policies.clear()
        t0 = time.perf_counter()
        with patched(E, "make_policy", keep):
            got = run_golden(scenario, device="cuda", **flags)
        wall = time.perf_counter() - t0
        tensors = [t for p in policies for t in agent_tensors(p.allocator)]
        if not tensors or not all(t.is_cuda for t in tensors):
            raise AssertionError(f"golden {path}: the agents' tensors are not all on the card "
                                 f"({[t.device for t in tensors]})")
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        log("simulator", f"golden {path}: {len(want)} keys, "
                         f"{'equal' if not diff else 'DIFFER: ' + ', '.join(diff)} "
                         f"({len(tensors)} agent tensors on {tensors[0].device}, "
                         f"{wall:.2f} s)")
        if diff:
            log("simulator", "  " + "; ".join(f"{k}: card {got.get(k)!r}, golden "
                                              f"{want.get(k)!r}" for k in diff))
            log("simulator", "  " + first_divergence(scenario, flags))
            failed.append(path)
    if failed:
        raise AssertionError(f"simulator: goldens differ on the card: {failed}")
    log("simulator", f"all {len(golden_cases())} golden summaries equal the committed "
                     f"snapshots exactly (tolerance 0), agents on the card")


def sim_figure8():
    """examples/serve_cluster_torch.py --quick on the card and on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "serve_cluster_torch", ROOT / "examples" / "serve_cluster_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    lines = {}
    for device in ("cuda", "cpu"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            example.main(["--quick", "--device", device])
        lines[device] = out.getvalue().splitlines()
        for line in lines[device]:
            log("simulator", f"figure 8 {device}: {line}")
        log("simulator", f"figure 8 {device}: {time.perf_counter() - t0:.1f} s")
    if len(lines["cuda"]) != 8 or lines["cuda"] != lines["cpu"]:
        raise AssertionError("simulator: figure 8 differs between the card and the CPU")
    log("simulator", "figure 8: the 8 printed lines are equal on the card and on the CPU")


SIM_KEYS = ("slo_violation_pct", "wasted_vcpus_p50", "wasted_mem_mb_p50")


def sim_scale(torch):
    """The scale deployment: the whole backlog on the card with the
    allocator's host calls timed (wrappers here, not in the package)."""
    from repro_torch.core import agent_arena as AA
    from repro_torch.core.allocator import ResourceAllocator

    t0 = time.perf_counter()
    spec = sim_scale_spec(SIM_SCALE_N)
    inputs = sim_inputs(spec)
    trace = inputs[3]
    log("simulator", f"scale: azure-24h, {len(trace)} invocations over {spec.duration_s:.0f} "
                     f"s, 10 clusters x 16 workers, queue admission; inputs built in "
                     f"{time.perf_counter() - t0:.1f} s")
    host = {name: [] for name in SIM_TIMED + ("arena flush",)}

    def timed(label):
        def make(orig):
            def wrapper(*args, **kwargs):
                t = time.perf_counter_ns()
                try:
                    return orig(*args, **kwargs)
                finally:
                    host[label].append(time.perf_counter_ns() - t)
            return wrapper
        return make

    with contextlib.ExitStack() as stack:
        for name in SIM_TIMED:
            stack.enter_context(patched(ResourceAllocator, name, timed(name)))
        stack.enter_context(patched(AA.ArenaEngine, "flush", timed("arena flush")))
        sim, summary, wall = sim_run(inputs, trace, "cuda")
    torch.cuda.synchronize()
    ev = sim.events_processed
    log("simulator", f"scale card: {len(trace)} invocations, {ev} events in {wall:.2f} s = "
                     f"{ev / wall:.0f} events/s ({len(trace) / wall:.0f} invocations/s) | "
                     + " ".join(f"{k}={summary[k]!r}" for k in SIM_KEYS))
    for name, ns in host.items():
        if not ns:
            log("simulator", f"  host {name}: 0 calls")
            continue
        us = sorted(n / 1e3 for n in ns)
        p99 = us[min(len(us) - 1, int(0.99 * len(us)))]
        log("simulator", f"  host {name}: {len(us)} calls, p50 {statistics.median(us):.1f} us, "
                         f"p99 {p99:.1f} us, total {sum(us) / 1e6:.2f} s = "
                         f"{100 * sum(us) / 1e6 / wall:.1f}% of the run")
    if not all(math.isfinite(summary[k]) for k in SIM_KEYS) or summary["n"] != len(trace):
        raise AssertionError(f"simulator: scale summary is not whole: {summary}")
    return inputs


def sim_profile(torch, inputs):
    """The backlog's first SIM_PROFILE_N invocations, untraced and then
    under torch.profiler: device kernels per invocation and the device's
    busy share of the untraced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prefix = inputs[3][:SIM_PROFILE_N]
    _, _, wall_p = sim_run(inputs, prefix, "cuda")
    torch.cuda.synchronize()
    # device activity only: host ops are not needed, and tracing them
    # multiplies the run's wall and the trace's size
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim_run(inputs, prefix, "cuda")
        torch.cuda.synchronize()
    kernels, copies = {}, [0, 0.0]
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies[0] += 1
            copies[1] += e.device_time_total / 1e3
            continue
        tot, cnt = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (tot + e.device_time_total / 1e3, cnt + 1)
    busy_ms = sum(t for t, _ in kernels.values()) + copies[1]
    launches = sum(c for _, c in kernels.values())
    if busy_ms <= 0:
        raise AssertionError("simulator: the profile holds no device time")
    log("simulator", f"scale profile, first {len(prefix)} invocations: untraced wall "
                     f"{wall_p:.2f} s; {launches} device kernels = "
                     f"{launches / len(prefix):.1f} per invocation, {copies[0]} copies/sets; "
                     f"device busy {busy_ms:.1f} ms = {100 * busy_ms / (wall_p * 1e3):.2f}% "
                     f"of the untraced wall")
    for kname, (t, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        log("simulator", f"  x{cnt:<7d} {t:9.3f} ms {kname[:90]}")


def sim_equal():
    """SIM_EQUAL_N invocations of the scale config on the card and on the
    CPU: the summaries must be equal."""
    small = sim_inputs(sim_scale_spec(SIM_EQUAL_N))
    summaries = {}
    for device in ("cuda", "cpu"):
        sim, summaries[device], wall_d = sim_run(small, small[3], device)
        log("simulator", f"scale {device}: {len(small[3])} invocations, "
                         f"{sim.events_processed} events in {wall_d:.2f} s = "
                         f"{sim.events_processed / wall_d:.0f} events/s | "
                         + " ".join(f"{k}={summaries[device][k]!r}" for k in SIM_KEYS))
    if summaries["cuda"] != summaries["cpu"]:
        raise AssertionError(f"simulator: {SIM_EQUAL_N}-invocation summaries differ: card "
                             f"{summaries['cuda']} != CPU {summaries['cpu']}")
    log("simulator", f"scale: the {SIM_EQUAL_N}-invocation summaries are equal on the card "
                     f"and on the CPU ({len(summaries['cpu'])} keys)")


def phase_simulator(torch):
    t0 = time.perf_counter()
    sim_goldens()
    log("simulator", f"goldens took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim_figure8()
    log("simulator", f"figure 8 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    inputs = sim_scale(torch)
    sim_profile(torch, inputs)
    log("simulator", f"scale and profile took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim_equal()
    log("simulator", f"card-vs-CPU scale run took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    # the float32 check frees most of a served model's layers and widens the
    # rest in place: without expandable segments the kept copies pin the
    # freed segments, and internvl2's widening runs out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _build, ops
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
    build_logs = _build.build()
    log("build", f"{', '.join(_build.KERNELS)} built from {_build.CSRC.relative_to(ROOT)} "
                 f"in {time.perf_counter() - t0:.1f} s")
    for kname, text in build_logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                info = line.strip().removeprefix("ptxas info    : ")
                log("build", f"  {kname} {entry}: {info}")
    check_sass(_build)

    # 3-7, each path's serve and profile in turn
    t0 = time.perf_counter()
    flash_rec, decode_rec = phase_kernels(torch)
    ssd_rec = phase_ssd_kernel(torch)
    gmm_rec = phase_moe_kernel(torch)
    grouped_rec = phase_moe_grouped(torch)
    log("kernels", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_reduced(torch)
    log("reduced", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_quickstart(torch)
    log("quickstart", f"phase took {time.perf_counter() - t0:.1f} s")
    counts = dict.fromkeys(ops.LAUNCHED, 0)
    # each path's counts are read from its own serve (and logged on its
    # serve line); the JSON line sums them over the paths. Each path's
    # engine is freed before the next is built: mixtral's weights take 47 GB,
    # internvl2-76b-40l's, served last, 72.7 GB
    for arch in ("qwen2.5-3b", "mamba2-1.3b", "zamba2-7b", "mixtral-8x7b-16l",
                 "nemotron-4-15b", "codeqwen1.5-7b", "phi3-mini-3.8b", "whisper-tiny",
                 "granite-4.0-h-small", "internvl2-76b-40l"):
        t0 = time.perf_counter()
        if arch == "internvl2-76b-40l":
            phase_refuse(torch, "internvl2-76b")
        engine, served, path_counts = phase_serve(torch, arch)
        for k in counts:
            counts[k] += path_counts[k]
        t1 = time.perf_counter()
        if arch in SERVE_ONLY:
            del engine, served
            torch.cuda.empty_cache()
            log("serve", f"{arch} serve took {t1 - t0:.1f} s (its float32 check is the "
                         f"benchmark's reference, portbench/references/)")
            continue
        phase_profile(torch, engine, served[0].prompt)
        t2 = time.perf_counter()
        phase_f32(torch, engine, served)
        del engine, served
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        log("serve", f"{arch} serve, profile and float32 check took {t3 - t0:.1f} s "
                     f"(serve {t1 - t0:.1f}, profile {t2 - t1:.1f}, float32 {t3 - t2:.1f})")

    counts_shapes = phase_shapes(torch, name_power)
    for k in counts:
        counts[k] += counts_shapes[k]
    t0 = time.perf_counter()
    phase_train(torch, name_power)
    log("train", f"phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_simulator(torch)
    log("simulator", f"phase took {time.perf_counter() - t0:.1f} s")

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:103",
         "launches": counts["flash_attention"], **flash_rec},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:80",
         "launches": counts["decode_attention"], **decode_rec},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:87",
         "launches": counts["ssd_scan"], **ssd_rec},
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm.py:47",
         "launches": counts["moe_gmm"], **gmm_rec},
        {"name": "moe_gmm_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
         "replaces": "none (the dropless dispatch's product; the TPU's dispatch is moe_gmm's)",
         "launches": counts["moe_gmm_grouped"], **grouped_rec},
    ]
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s on {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
