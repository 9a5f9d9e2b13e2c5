"""Dry run: plan, count and (on the card) run each (arch x shape x mesh)
(port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape prefill_32k [--mesh 1x1|16x16|2x16x16] [--batch N] [--run] \\
        [--out build/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh ...]

For each combination where ``shape_applicable`` holds it writes one JSON
record to ``--out``:

1. the **plan**: per-device bytes of the parameters, the optimizer state
   (train), the decode cache and the other inputs under the sharding rules
   (``distributed.sharding``) on the mesh, and whether the total fits one
   card (the card's memory where one is present, else the H100's 80 GB);
2. on the one-card mesh, the **cost** of the full-depth step on
   ``device="meta"`` tensors, nothing allocated: FLOPs from
   ``FlopCounterMode``, and bytes as the operand and result bytes of
   every aten op that is not a view (:class:`ByteCounter`). ``cost`` is
   the step as the card runs it: each kernel the step launches counts
   its own work from its shapes (:func:`kernel_costs`: the attention
   band's pairs, its inputs read and output written once; on meta every
   decode slot counts as live and every expert as holding tokens).
   ``cost_plain`` is the same step with ``use_kernels=False``, every
   eager op's traffic included. Training runs the plain path either way;
3. ``roofline_terms`` of both with ``launch.mesh``'s H100 constants and
   no collective (one card runs none): the eager traffic of the step as
   written, which grows with every pass the code makes. Beside them the
   **floor** (:func:`floor`), the least time the card could take for the
   step's function: its FLOPs with attention over the live pairs, and the
   bytes it must move (the plan read once, the results written once).
   Production-mesh records carry the plan alone;
4. with ``--run`` (a CUDA card, the one-card mesh only): the step at
   ``--batch`` with the kernels on (:func:`measure`): step ms from CUDA
   events, tokens/s, ``memory_allocated`` once parameters, optimizer
   state, cache and inputs are in place, the peak, and kernel launches.

The reference lowers and compiles each step with XLA and reads
``memory_analysis`` / ``cost_analysis``; XLA counts a scan body once, so
it extrapolates from two shallow compiles (``extrapolate_costs``) and
parses collectives out of the HLO text. The port's layer loop is plain
Python, so the counters see every layer, and a one-device eager program
has no HLO, no sharding constraints and no donation: the plan and the
card's measured memory take the place of ``memory_analysis``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    canonical_id,
    decoder_seq_len,
    get_config,
    input_specs,
    shape_applicable,
)
from repro_torch.distributed import sharding as sh
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as M
from repro_torch.launch.roofline import model_flops_estimate, roofline_terms
from repro_torch.launch.steps import (
    adamw_config_for,
    eval_opt_shapes,
    eval_param_shapes,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from repro_torch.models.kv_cache import cross_mask, init_cache
from repro_torch.models.model import forward_seq
from repro_torch.training.optimizer import init_opt_state

DEFAULT_OUT = "build/dryrun_torch"


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _per_device(tree, specs, mesh) -> int:
    if isinstance(tree, dict):
        return sum(_per_device(v, specs[k], mesh) for k, v in tree.items())
    return _nbytes(tree) // sh.shard_count(specs, mesh)


def plan(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """Per-device bytes of what the step holds before it runs (a tied
    head, a view of the embedding, holds none of its own)."""
    params = eval_param_shapes(cfg)
    if cfg.tie_embeddings:
        params = {k: v for k, v in params.items() if k != "lm_head"}
    pspecs = sh.param_spec_tree(cfg, mesh, "train" if shape.kind == "train" else "serve",
                                params)
    specs = input_specs(cfg, shape)
    ispecs = sh.input_spec_tree(cfg, mesh, shape, specs)
    out = {"params_bytes": _per_device(params, pspecs, mesh), "opt_state_bytes": 0,
           "cache_bytes": 0}
    if shape.kind == "train":
        out["opt_state_bytes"] = _per_device(eval_opt_shapes(cfg, params),
                                             sh.opt_state_specs(pspecs), mesh)
    if "cache" in specs:
        out["cache_bytes"] = _per_device(specs.pop("cache"), ispecs.pop("cache"), mesh)
    out["input_bytes"] = _per_device(specs, ispecs, mesh)
    out["total_bytes"] = sum(out.values())
    out["card_bytes"] = M.card_memory_bytes()
    out["fits_card"] = out["total_bytes"] <= out["card_bytes"]
    return out


# ---------------------------------------------------------------------------
# Cost on meta tensors
# ---------------------------------------------------------------------------


# factory ops that only reserve memory: no traffic
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided}
# in-place scatters (a ring write, a prefill's cache fill, MoE dispatch):
# they touch the rows they write, not the whole destination
_SCATTER = {torch.ops.aten.index_put_, torch.ops.aten._index_put_impl_}


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each aten op
    that is not a view (an in-place op's tensor counts as read and
    written); an in-place scatter counts its indices and values read and
    the values written."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused or func.is_view or func.overloadpacket in _NO_TRAFFIC:
            return out
        if func.overloadpacket in _SCATTER:  # (self, indices, values, ...)
            self.bytes += _tensor_bytes(args[1]) + 2 * _nbytes(args[2])
        else:
            self.bytes += _tensor_bytes((args, kwargs, out))
        return out


def live_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs of a length-S self-attention that the mask keeps."""
    q = np.arange(S, dtype=np.int64)
    hi = q + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


@contextlib.contextmanager
def kernel_costs(bytes_counter: ByteCounter, extra: Dict[str, float]):
    """While entered, ``ops``' kernels take meta tensors: each returns an
    empty result of its output's shape and adds its own work to
    ``extra["flops"]`` and ``bytes_counter`` (inputs read and outputs
    written once). Attention counts the pairs its mask keeps (a decode
    step every slot); ``moe_gmm`` every expert's rows, ``moe_gmm_grouped``
    every sorted row and every expert's weights; the SSD scan the
    matmul FLOPs of its plain chunked form. A call with
    ``use_kernels=False`` still takes the plain version and is counted as
    the step's own operations (a train step runs the plain path inside
    this context), but for ``moe_gmm_grouped``, counted as its kernel on
    both paths: its plain version reads the group offsets on the host,
    which a meta tensor does not hold."""
    saved = {name: getattr(ops, name) for name in
             ("flash_attention", "decode_attention", "moe_gmm", "moe_gmm_grouped",
              "ssd_scan")}

    def moved(*tensors):
        bytes_counter.bytes += sum(_nbytes(t) for t in tensors if t is not None)

    def flash(q, k, v, *, causal=True, window=None, scale=None):
        B, S, H, D = q.shape
        extra["flops"] += 4 * B * H * D * live_pairs(S, causal, window)
        moved(q, k, v, q)
        return torch.empty_like(q)

    def decode(q, k, v, kv_positions, kv_valid, q_pos, *, scale=None):
        B, _, H, D = q.shape
        extra["flops"] += 4 * B * H * D * k.shape[1]
        moved(q, k, v, kv_positions, kv_valid, q_pos, q)
        return torch.empty_like(q)

    def gmm(buf, w):
        E, C, D = buf.shape
        extra["flops"] += 2 * E * C * D * w.shape[-1]
        out = torch.empty((E, C, w.shape[-1]), dtype=buf.dtype, device=buf.device)
        moved(buf, w, out)
        return out

    def grouped(x, w, offsets):
        extra["flops"] += 2 * x.shape[0] * x.shape[1] * w.shape[-1]
        out = torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
        moved(x, w, offsets, out)
        return out

    def ssd(x, dt, A, B_, C_, chunk, init_state=None):
        bytes_counter.paused = True
        try:
            y, state = ref.ssd_scan_ref(x, dt, A, B_, C_, chunk, init_state)
        finally:
            bytes_counter.paused = False
        moved(x, dt, A, B_, C_, init_state, y, state)
        return y, state

    def kernel(name, cost):
        def call(*args, use_kernels=True, **kwargs):
            if not use_kernels and name != "moe_gmm_grouped":
                return saved[name](*args, use_kernels=False, **kwargs)
            return cost(*args, **kwargs)
        return call

    try:
        for name, cost in (("flash_attention", flash), ("decode_attention", decode),
                           ("moe_gmm", gmm), ("moe_gmm_grouped", grouped),
                           ("ssd_scan", ssd)):
            setattr(ops, name, kernel(name, cost))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def step_cost(cfg: ModelConfig, shape: ShapeConfig, *, use_kernels: bool = True
              ) -> Dict[str, float]:
    """FLOPs and bytes of one full-depth step on meta tensors, and
    ``written_bytes``, the bytes of the step's results (each written once):
    a train step's parameters and moments; a prefill's logits and cache; a
    decode step's logits, ``pos``, one new K/V row per attention layer and
    the whole SSM state (the encoder's cached K/V are only read)."""
    params = eval_param_shapes(cfg)
    specs = input_specs(cfg, shape)
    extra = {"flops": 0.0}
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        # the plain path too: its calls take the plain versions, but for the
        # grouped product, which meta tensors cannot run plain
        with kernel_costs(nbytes, extra):
            if shape.kind == "train":
                opt_state = eval_opt_shapes(cfg, params)
                make_train_step(cfg)(params, opt_state, specs)
                written = _tensor_bytes((params, opt_state))
            elif shape.kind == "prefill":
                with torch.no_grad():
                    out = make_prefill_step(cfg, shape, use_kernels=use_kernels)(params, specs)
                written = _tensor_bytes(out)
            else:
                cache = dict(specs["cache"])
                if cfg.is_encoder_decoder:
                    cache.update(cross_mask(shape.global_batch, cfg.encoder_seq, "meta"))
                with torch.no_grad():
                    logits, _ = make_serve_step(cfg, use_kernels=use_kernels)(
                        params, cache, specs["token"])
                rows = {"k": 2, "v": 2}  # the window's axis in (L, B, W, Hkv, hd)
                written = _nbytes(logits) + sum(
                    _nbytes(t) // (t.shape[rows[k]] if k in rows else 1)
                    for k, t in specs["cache"].items() if k not in ("xk", "xv"))
    return {"flops": float(flops.get_total_flops()) + extra["flops"],
            "bytes": float(nbytes.bytes), "written_bytes": float(written)}


def floor(cfg: ModelConfig, shape: ShapeConfig, plan1: Dict[str, Any],
          cost: Dict[str, float]) -> Dict[str, Any]:
    """The least time one card could take for the step's function, however
    it is written: the larger of its FLOPs over the bf16 peak and the bytes
    it must move over the HBM rate (``cost``'s bytes are the eager traffic
    of the step as written, which grows with every pass the code makes).

    FLOPs: a prefill or decode step's ``cost`` (the kernels count their own
    work: attention over the pairs its mask keeps; the lm_head runs over
    every position, as the reference's prefill computes it); a train
    step's, three times its forward's counted so (the backward costs
    twice the forward; nothing recomputed). Bytes: the one-card plan
    (parameters, moments, cache and inputs) read once, and the results
    (``cost["written_bytes"]``) written once."""
    flops = cost["flops"]
    if shape.kind == "train":
        specs = input_specs(cfg, shape)
        extra = {"flops": 0.0}
        with FlopCounterMode(display=False) as counted, ByteCounter() as unused, \
                kernel_costs(unused, extra), torch.no_grad():
            forward_seq(eval_param_shapes(cfg), cfg, specs["tokens"],
                        patch_embeds=specs.get("patch_embeds"),
                        frame_embeds=specs.get("frame_embeds"))
        flops = 3.0 * (counted.get_total_flops() + extra["flops"])
    nbytes = float(plan1["total_bytes"]) + cost["written_bytes"]
    compute_s, memory_s = flops / M.PEAK_FLOPS_BF16, nbytes / M.HBM_BW
    return {"flops": float(flops), "bytes": nbytes, "compute_s": compute_s,
            "memory_s": memory_s, "bound_s": max(compute_s, memory_s),
            "by": "operations" if compute_s >= memory_s else "bytes"}


def roofline(cfg: ModelConfig, shape: ShapeConfig, cost: Dict[str, float]) -> Dict:
    return roofline_terms(
        per_device_flops=cost["flops"], per_device_bytes=cost["bytes"],
        per_device_collective_bytes=0.0, chips=1,
        model_flops=model_flops_estimate(cfg, shape), peak_flops=M.PEAK_FLOPS_BF16,
        hbm_bw=M.HBM_BW, link_bw=M.NVLINK_BW).to_dict()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def step_inputs(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random inputs of the shape's step (``input_specs``' keys and shapes)
    from ``gen``; a decode cache is seeded and its ``pos`` set so that the
    step after ``steps`` more sits at ``seq_len - 1`` (see :func:`measure`)."""
    batch = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "cache":
            batch[name] = init_cache(cfg, shape, device=device, generator=gen)
        elif spec.dtype == torch.int32:
            batch[name] = torch.randint(1, cfg.vocab_size, tuple(spec.shape), generator=gen,
                                        dtype=torch.int32, device=device)
        else:
            batch[name] = torch.randn(tuple(spec.shape), generator=gen, device=device
                                      ).to(spec.dtype)
    return batch


def measure(cfg: ModelConfig, shape: ShapeConfig, params, *, steps: int = 3,
            base_bytes: Optional[int] = None, seed: int = 1) -> Dict[str, Any]:
    """Run the shape's step on the card with the kernels on: one warm-up
    step, then ``steps`` timed ones (CUDA events around each). ``params``
    are on the card already (a train step updates them in place).
    ``base_bytes`` is ``memory_allocated`` before they were made (by
    default now, so that the parameters are not counted). A decode cache
    starts at position ``seq_len - steps - 1``: the last timed step's
    query sits at ``seq_len - 1``."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure needs a CUDA card; the plan and the cost run anywhere")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() if base_bytes is None else base_bytes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = step_inputs(cfg, shape, gen)
    if shape.kind == "train":
        opt_state = init_opt_state(adamw_config_for(cfg), params)
        train = make_train_step(cfg)

        def step():
            train(params, opt_state, batch)
    elif shape.kind == "prefill":
        prefill = make_prefill_step(cfg, shape)

        def step():
            prefill(params, batch)
    else:
        cache, token = batch["cache"], batch["token"]
        cache["pos"].fill_(shape.seq_len - steps - 1)
        serve = make_serve_step(cfg)

        def step():
            serve(params, cache, token)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    grad = contextlib.nullcontext() if shape.kind == "train" else torch.inference_mode()
    with grad:
        step()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ms = []
        for _ in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            step()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    launches = ops.launch_counts()
    median = statistics.median(ms)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else decoder_seq_len(cfg, shape))
    return {"device": torch.cuda.get_device_name(0), "step_ms": ms, "median_ms": median,
            "tokens_per_s": tokens / (median / 1e3), "resident_bytes": resident,
            "peak_bytes": torch.cuda.max_memory_allocated() - base, "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()}}


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def record(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """The plan on ``mesh``; on the one-card mesh also the costs and their
    rooflines."""
    rec = {"arch": cfg.name, "shape": shape.name, "kind": shape.kind,
           "seq_len": shape.seq_len, "batch": shape.global_batch, "mesh": mesh.label,
           "axes": list(mesh.axis_names), "chips": mesh.size,
           "param_count": cfg.param_count(), "active_param_count": cfg.active_param_count(),
           "plan": plan(cfg, shape, mesh)}
    if mesh.size == 1:
        t0 = time.perf_counter()
        rec["cost"] = step_cost(cfg, shape)
        rec["cost_plain"] = (rec["cost"] if shape.kind == "train"
                             else step_cost(cfg, shape, use_kernels=False))
        rec["cost_s"] = time.perf_counter() - t0
        rec["roofline"] = roofline(cfg, shape, rec["cost"])
        rec["roofline_plain"] = roofline(cfg, shape, rec["cost_plain"])
        rec["floor"] = floor(cfg, shape, rec["plan"], rec["cost"])
    return rec


def _write(out_dir: Path, rec: Dict[str, Any]) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{rec['arch'].replace('.', '_')}__{rec['shape']}__{rec['mesh']}.json"
    path.write_text(json.dumps(rec, indent=2, default=str))
    return path


def run_one(arch: str, shape_name: str, mesh_name: str = "1x1", out_dir=DEFAULT_OUT, *,
            batch: Optional[int] = None, run: bool = False, log=print) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if batch is not None:  # the one-card cut
        shape = dataclasses.replace(shape, global_batch=batch)
    mesh = M.MESHES[mesh_name]()
    if not shape_applicable(cfg, shape):
        rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh.label, "skipped": True,
               "reason": f"{shape.name} inapplicable: {cfg.name} has no long-context variant"}
        _write(Path(out_dir), rec)
        log(f"SKIP  {cfg.name} x {shape.name}: {rec['reason']}")
        return rec
    rec = record(cfg, shape, mesh)
    p = rec["plan"]
    line = (f"OK    {cfg.name} x {shape.name} B={shape.global_batch} mesh={mesh.label} "
            f"per device: params {p['params_bytes'] / 1e9:.3f} GB, opt "
            f"{p['opt_state_bytes'] / 1e9:.3f} GB, cache {p['cache_bytes'] / 1e9:.3f} GB, "
            f"inputs {p['input_bytes'] / 1e9:.4f} GB = {p['total_bytes'] / 1e9:.3f} GB "
            f"(fits one card: {p['fits_card']})")
    if "roofline" in rec:
        r, f = rec["roofline"], rec["floor"]
        line += (f"; eager traffic of the step as written: {rec['cost']['flops']:.4e} FLOP, "
                 f"{rec['cost']['bytes']:.4e} B: compute {r['compute_s']:.4g} s, memory "
                 f"{r['memory_s']:.4g} s ({r['dominant']}); plain step memory "
                 f"{rec['roofline_plain']['memory_s']:.4g} s; floor {f['bound_s']:.4g} s "
                 f"(by {f['by']}: {f['flops']:.4e} FLOP, {f['bytes']:.4e} B)")
    log(line)
    if run:
        if mesh.size != 1:
            raise ValueError("--run runs on one card: --mesh 1x1")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params = _card_params(cfg)
        rec["run"] = measure(cfg, shape, params, base_bytes=base)
        log(f"RUN   {cfg.name} x {shape.name}: {rec['run']}")
    _write(Path(out_dir), rec)
    return rec


def _card_params(cfg: ModelConfig):
    from repro_torch.models.model import init_params

    return init_params(torch.Generator(device="cuda").manual_seed(0), cfg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1", choices=sorted(M.MESHES))
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step takes (the shape's global batch by default)")
    ap.add_argument("--run", action="store_true", help="run the step on the card")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(canonical_id(args.arch), args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    return [run_one(a, s, args.mesh, args.out, batch=args.batch, run=args.run)
            for a, s in combos]


if __name__ == "__main__":
    main()
