"""One run of one cell: set-up, the measured window, the check, the result.

A cell (``cells/<name>.json``) names a configuration
(``configs/<name>.json``, whose ``reference`` names its plain reference
under ``references/``) and a traffic mix (``traffic/<name>.json``), and
holds what was fixed for it on the card: the open loop's rate, the fit
of the isolated service time behind each invocation's SLO, the traced
share of the window and the check's sample and limits. The metrics a
cell reports are the entries of ``BENCHMARK.json`` that name it (or name
no cell), each read by ``metrics/<name>.py``. So a new configuration,
mix, cell or metric is a new file and a new entry. The cell of a
configuration with experts also holds the limit of its route deficit
(``check.py``).

The measured program is ``repro_torch``: one serving engine, built on
the weights the reference module makes from the seed, and Shabari's
loop around it, the four calls ``launch/serve.py`` makes (featurize,
allocate, generate, feedback), driven one invocation at a time. The
feedback's usage fields follow ``launch/serve.py``'s synthetic rule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench import check, devtrace, traffic, work

PB = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SLO_MULTIPLIER = 1.4  # the paper's SLO: 1.4x the input's best execution time
# the allocator as launch/serve.py builds it: predictions after 2 (vCPU) and
# 4 (memory) feedbacks; 32 vCPU classes, 40 memory classes of 128 MB, the
# defaults 10 vCPUs and class 32 below confidence
VCPU_CONFIDENCE, MEM_CONFIDENCE = 2, 4
WARM_LENGTHS = 4  # prompt lengths warmed for each batch size, across the mix's range

# configuration-file keys (Hugging Face names) -> the port's ModelConfig fields
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
    "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps", "sliding_window": "sliding_window",
    "num_local_experts": "num_experts", "num_experts_per_tok": "experts_per_token",
    "attention_bias": "qkv_bias", "torch_dtype": "dtype",
}


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Spec:
    name: str
    cell: Dict
    config: Dict
    mix: Dict
    end_to_end: List[str]
    per_layer: List[str]
    root: Path

    @property
    def cache_window(self) -> int:
        """The smallest ring that holds the mix's longest prompt and output,
        or the published sliding window where that is smaller."""
        need = math.ceil(self.mix["prompt_tokens"]["loguniform"][1]) + max(
            self.mix["max_new_tokens"]["values"])
        sw = self.config.get("sliding_window")
        return min(need, sw) if sw else need

    def reference(self):
        return load_module(self.root / "references" / f"{self.config['reference']}.py")

    def reader(self, metric: str):
        return load_module(self.root / "metrics" / f"{metric}.py")


def load_spec(workload: str, root: Path = PB, bench: Optional[Path] = None) -> Spec:
    bench = json.loads((bench or root.parent / "BENCHMARK.json").read_text())
    cell = json.loads((root / "cells" / f"{workload}.json").read_text())
    config = json.loads((root / "configs" / f"{cell['config']}.json").read_text())
    mix = traffic.load(root / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    if config.get("num_local_experts") and "route_deficit" not in cell["check"]:
        raise ValueError(f"cell {workload}: a configuration with experts needs the limit "
                         "check.route_deficit")
    return Spec(workload, cell, config, mix,
                [m["name"] for m in bench["end_to_end"] if mine(m)],
                [m["name"] for m in bench["per_layer"] if mine(m)], root)


def port_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig

    kw = {f: cfg[k] for k, f in PORT_FIELDS.items() if k in cfg}
    kw.update(cfg["port"])
    out = ModelConfig(name=cfg["name"], source=cfg["source"], **kw)
    out.validate()
    return out


@dataclasses.dataclass
class Record:
    """One invocation as served; times are host ``perf_counter`` seconds."""
    index: int
    prompts: List[np.ndarray]
    max_new: int
    due: float
    start: float = 0.0  # before featurize
    t_alloc: float = 0.0  # allocation made
    t_gen: float = 0.0  # last token
    end: float = 0.0  # feedback given
    prefill_s: float = 0.0
    decode_s: float = 0.0
    slo_s: float = 0.0
    vcpus: int = 0
    mem_mb: int = 0
    tokens: Optional[List[List[int]]] = None
    failed: bool = False
    idle_wait: bool = False  # the server waited for this one to be due

    @property
    def batch(self) -> int:
        return len(self.prompts)

    @property
    def padded_len(self) -> int:
        return max(len(p) for p in self.prompts)

    @property
    def prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    spec: Spec
    dims: work.Dims
    cache_window: int
    t0: float
    setup_s: float
    records: List[Record]
    traced: List[Record]
    trace: Optional[devtrace.DeviceTrace]


def slo_s(cell: Dict, batch: int, padded: int, max_new: int) -> float:
    """1.4x the cell's fit of the isolated service time."""
    f = cell["slo_fit"]
    return SLO_MULTIPLIER * (f["k0_s"] + f["k1_s_per_prompt_token"] * batch * padded
                             + f["k2_s_per_new_token"] * max_new)


class Loop:
    """Shabari's loop on the engine: featurize, allocate, generate, feedback."""

    def __init__(self, spec: Spec, engine, device):
        from repro_torch.core import Featurizer, ResourceAllocator

        self.spec, self.engine = spec, engine
        self.feat = Featurizer()
        self.alloc = ResourceAllocator(vcpu_confidence=VCPU_CONFIDENCE,
                                       mem_confidence=MEM_CONFIDENCE, device=device)

    def serve(self, rec: Record) -> None:
        from repro_torch.core import Observation

        from portbench.references.shabari_allocator import usage

        fn = self.spec.name
        rec.start = time.perf_counter()
        x = self.feat.extract(fn, "request", {
            "prompt_tokens": rec.padded_len, "batch": rec.batch, "max_new_tokens": rec.max_new,
            "image_tiles": 0, "audio_seconds": 0})
        a = self.alloc.allocate(fn, x)
        rec.vcpus, rec.mem_mb = a.vcpus, a.mem_mb
        rec.t_alloc = time.perf_counter()
        res = self.engine.generate([p.tolist() for p in rec.prompts], max_new_tokens=rec.max_new)
        rec.t_gen = time.perf_counter()
        rec.tokens, rec.prefill_s, rec.decode_s = res.tokens, res.prefill_s, res.decode_s
        used_v, used_mb = usage(rec.prompt_tokens, a.vcpus)
        self.alloc.feedback(fn, x, Observation(
            exec_time_s=res.prefill_s + res.decode_s, slo_s=rec.slo_s, alloc_vcpus=a.vcpus,
            max_vcpus_used=used_v, alloc_mem_mb=a.mem_mb, max_mem_used_mb=used_mb))
        rec.end = time.perf_counter()


def warm_shapes(spec: Spec, invocations) -> List[traffic.Invocation]:
    """One invocation for each batch size of the mix at each of a few
    prompt lengths across its range, with the most new tokens: the
    shapes (and so the library kernels) the window will run."""
    lo, hi = spec.mix["prompt_tokens"]["loguniform"]
    lengths = sorted({int(round(x)) for x in np.geomspace(lo, hi, WARM_LENGTHS)})
    m = max(spec.mix["max_new_tokens"]["values"])
    src = np.concatenate([p for inv in invocations[:4] for p in inv.prompts])
    out = []
    for b in spec.mix["batch"]["values"]:
        for L in lengths:
            out.append(traffic.Invocation(-1, None, [np.resize(src, L) for _ in range(b)], m))
    return out


def _records(invs, t0: float) -> List[Record]:
    return [Record(i.index, i.prompts, i.max_new, t0 + (i.due or 0.0)) for i in invs]


def serve_window(spec: Spec, loop: Loop, invocations, seconds: float, t0: float,
                 tracer: Optional[devtrace.Tracer] = None):
    """The measured window. Open loop: every invocation at its due time or
    as soon as the one before it ends. Closed loop: one caller replays the
    documents in order, in whole passes over the set, until a pass ends at
    or after ``seconds``: every document is served equally often, so the
    seed changes only the order of the window's work, never its multiset.
    Returns (records, traced, trace)."""
    open_loop = spec.mix["loop"] == "open"
    records: List[Record] = []
    traced, trace = [], None
    trace_until = t0 + spec.cell["trace_seconds"]
    i = 0
    while True:
        if open_loop:
            if i == len(invocations):
                break
            inv = invocations[i]
            rec = Record(inv.index, inv.prompts, inv.max_new, t0 + inv.due)
            wait = rec.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
                rec.idle_wait = True
        else:
            now = time.perf_counter()
            if i % len(invocations) == 0 and now >= t0 + seconds:
                break
            inv = invocations[i % len(invocations)]
            rec = Record(i, inv.prompts, inv.max_new, now)
        rec.slo_s = slo_s(spec.cell, rec.batch, rec.padded_len, rec.max_new)
        try:
            loop.serve(rec)
        except torch.cuda.OutOfMemoryError:
            rec.failed = True
            rec.t_gen = rec.end = time.perf_counter()
        records.append(rec)
        i += 1
        if tracer is not None and trace is None and rec.end >= trace_until:
            traced = list(records)
            trace = tracer.stop((traced[0].start, rec.end))
    if tracer is not None and trace is None:
        traced = list(records)
        trace = tracer.stop((traced[0].start, records[-1].end))
    return records, traced, trace


def device_info(device) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info["power_limit"] = "not read"
    return info


def forbidden_modules(names=None) -> List[str]:
    """Top-level names (whole, before the first dot) of loaded modules that
    the benchmark may not load: JAX, its libraries, the reference package."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def start(spec: Spec, seed: int, invocations, device):
    """Set-up: the weights from the seed, the engine, and the warm-up of the
    cell's shapes through a loop of its own. Returns (weights, engine)."""
    from repro_torch.serving.engine import ServingEngine

    weights = spec.reference().make_weights(spec.config, seed, device)
    engine = ServingEngine(port_config(spec.config), params=weights,
                           cache_window=spec.cache_window, device=device)
    warm = Loop(spec, engine, device)
    for inv in warm_shapes(spec, invocations):
        warm.serve(_records([inv], 0.0)[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return weights, engine


@dataclasses.dataclass
class Served:
    """A run up to the close of its window, the program's state freed."""
    spec: Spec
    seed: int
    device: torch.device
    weights: Dict
    ctx: Context
    dev: Dict


def serve(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
          device="cuda", root: Path = PB, bench: Optional[Path] = None) -> Served:
    device = torch.device(device)
    seed = int(seed) % (1 << 64)
    spec = load_spec(workload, root, bench)
    invocations = traffic.generate(spec.mix, seed, spec.config["vocab_size"],
                                   rate=spec.cell.get("rate_per_s"), seconds=seconds)
    weights, engine = start(spec, seed, invocations, device)
    loop = Loop(spec, engine, device)
    tracer = devtrace.Tracer() if (trace and device.type == "cuda") else None
    if tracer is not None:
        tracer.start()
    gc.collect()
    t0 = time.perf_counter() + 0.01
    setup_s = t0 - t_start
    records, traced, dtrace = serve_window(spec, loop, invocations, seconds, t0, tracer)
    dev = device_info(device)
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy([dtrace.window])
        dev["window_s"] = dtrace.window_s
    del loop, engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = Context(spec, work.dims(spec.config), spec.cache_window, t0, setup_s, records,
                  traced if dtrace is not None else records, dtrace)
    return Served(spec, seed, device, weights, ctx, dev)


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device="cuda", root: Path = PB, bench: Optional[Path] = None) -> Dict:
    """One run; returns the result line's object (``checks`` last)."""
    sv = serve(workload, seed, seconds, trace, t_start=t_start, device=device, root=root,
               bench=bench)
    spec, ctx = sv.spec, sv.ctx
    units = _units(root, bench)
    metrics = {}
    for name in (spec.per_layer if trace else spec.end_to_end):
        v = spec.reader(name).read(ctx)
        if v is not None and math.isfinite(v):
            metrics[name] = {"value": float(v), "unit": units[name]}
    checks = judge(sv)
    records = ctx.records
    lateness = [r.start - r.due for r in records if r.idle_wait]
    result = {
        "correct": passes(checks),
        "attempted": len(records),
        "failed": sum(r.failed for r in records),
        "metrics": metrics,
        "device": sv.dev,
    }
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                               "idle_gaps": devtrace.idle_by_phase(ctx.trace, ctx.traced)}
    result["generator"] = {
        "late_starts": len(lateness),
        "lateness_ms_median": statistics.median(lateness) * 1e3 if lateness else 0.0,
        "lateness_ms_max": max(lateness) * 1e3 if lateness else 0.0,
        "last_token_s": max(r.t_gen for r in records) - ctx.t0}
    result["checks"] = checks
    return result


@contextlib.contextmanager
def recorded_routes() -> Iterator[List[torch.Tensor]]:
    """Every call of the program's router inside the block appends its
    expert ids (tokens, k) to the list yielded; the router is restored on
    leaving, also after an error."""
    from repro_torch.models import moe

    calls: List[torch.Tensor] = []
    inner = moe.route

    def route(p, cfg, xt):
        probs, gates, ids = inner(p, cfg, xt)
        calls.append(ids.clone())
        return probs, gates, ids

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = inner


@torch.inference_mode()
def serve_again(sv: Served, recs: List[Record]):
    """Serve ``recs`` again through the program's eager loop, as
    ``ServingEngine.generate`` does without its decode graph: the same
    left-padded batch (pad 0), ``forward_prefill`` at the cell's cache
    window, greedy ``forward_decode`` steps, on the run's weights. Returns
    (tokens, router calls) per invocation."""
    from repro_torch.models.model import forward_decode, forward_prefill

    cfg = port_config(sv.spec.config)
    out = []
    for r in recs:
        arr = np.zeros((r.batch, r.padded_len), np.int32)
        for i, p in enumerate(r.prompts):
            arr[i, r.padded_len - len(p):] = p
        with recorded_routes() as calls:
            logits, cache = forward_prefill(sv.weights, cfg, torch.from_numpy(arr).to(sv.device),
                                            cache_window=sv.spec.cache_window, use_kernels=True)
            tok = torch.argmax(logits, -1).to(torch.int32)
            toks: List[List[int]] = [[] for _ in r.prompts]
            for _ in range(r.max_new):
                for row, t in zip(toks, tok.tolist()):
                    row.append(t)
                logits, cache = forward_decode(sv.weights, cfg, tok, cache, use_kernels=True)
                tok = torch.argmax(logits, -1).to(torch.int32)
        out.append((toks, calls))
    return out


def judge(sv: Served, control: bool = False) -> Dict:
    """Each number compared, with its limit (a number passes at or under it).
    ``control`` (calibration only) adds every number read, the program's
    and the control's, under ``read``, outside the checks. A configuration
    with experts serves the sample again to record its routing
    (:func:`serve_again`) and is checked against the reference routed as the
    program routed (``check.py``)."""
    from portbench.references import shabari_allocator as RA

    spec, records = sv.spec, sv.ctx.records
    lim = spec.cell["check"]
    done = [r for r in records if not r.failed]
    replayed = RA.replay(
        [{"padded_len": r.padded_len, "batch": r.batch, "max_new": r.max_new,
          "exec_s": r.prefill_s + r.decode_s, "slo_s": r.slo_s,
          "prompt_tokens": r.prompt_tokens} for r in done],
        vcpu_classes=32, mem_classes=40, vcpu_confidence=VCPU_CONFIDENCE,
        mem_confidence=MEM_CONFIDENCE, default_vcpus=10, default_mem_class=32, class_mb=128)
    mismatches = sum((r.vcpus, r.mem_mb) != tuple(x) for r, x in zip(done, replayed))
    bad = check.well_formed(records, spec.config["vocab_size"])
    failed = sum(r.failed for r in records)
    recs = check.sample(done, sv.seed, lim["served_tokens"])
    experts = bool(spec.config.get("num_local_experts"))
    routed, again = None, None
    if experts and recs and not bad:
        layers, k = spec.config["num_hidden_layers"], spec.config["num_experts_per_tok"]
        served = serve_again(sv, recs)
        again = sum(toks != r.tokens for r, (toks, _) in zip(recs, served))
        routed = [check.routes(calls, layers, k, r) for r, (_, calls) in zip(recs, served)]
    got = (check.served_numbers(spec.reference(), sv.weights, spec.config, recs,
                                spec.cache_window, sv.device, control, routed)
           if recs and not bad else {})
    checks = {
        "failed_invocations": {"value": failed, "limit": 0},
        "malformed_invocations": {"value": bad, "limit": 0},
        "allocation_mismatches": {"value": mismatches, "limit": 0},
        "logit_gap": {"value": got.get("logit_gap"), "limit": lim["logit_gap"],
                      "tokens": got.get("tokens", 0), "invocations": len(recs)},
    }
    if experts:
        checks["route_deficit"] = {"value": got.get("route_deficit"),
                                   "limit": lim["route_deficit"], "choices": got.get("choices", 0)}
        checks["reserve_mismatches"] = {"value": again, "limit": 0}
    if control:
        checks["read"] = got
    return checks


def passes(checks: Dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def _units(root: Path, bench: Optional[Path]) -> Dict[str, str]:
    b = json.loads((bench or root.parent / "BENCHMARK.json").read_text())
    return {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
