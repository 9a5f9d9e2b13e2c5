"""A copy of the benchmark with tiny cells added by new files only, for
runs on the CPU: a dense and an expert configuration at test size, a
short open-loop mix and a closed-loop one, and their cells."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]

TINY = {
    "tiny-dense": {"model_type": "qwen2", "hidden_size": 64, "intermediate_size": 128,
                   "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "vocab_size": 512, "attention_bias": True,
                   "rope_theta": 1000000.0, "rms_norm_eps": 1e-05, "sliding_window": None,
                   "torch_dtype": "bfloat16", "port": {"family": "dense", "mlp_type": "swiglu"}},
    "tiny-moe": {"model_type": "mixtral", "hidden_size": 64, "intermediate_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
                 "head_dim": 16, "vocab_size": 512, "num_local_experts": 4,
                 "num_experts_per_tok": 2, "attention_bias": False, "rope_theta": 1000000.0,
                 "rms_norm_eps": 1e-05, "sliding_window": 24, "torch_dtype": "bfloat16",
                 "port": {"family": "moe", "mlp_type": "swiglu"}},
}
MIXES = {
    "tiny-open": {"loop": "open", "batch": {"values": [1, 2, 4], "weights": [0.5, 0.25, 0.25]},
                  "prompt_tokens": {"loguniform": [6, 40]},
                  "max_new_tokens": {"values": [1, 2, 4], "weights": [0.4, 0.3, 0.3]},
                  "shape_seed": 0, "block": 4,
                  "stratify_by": {"prefill_tokens": 1.0, "decode_steps": 20.0}},
    "tiny-closed": {"loop": "closed", "documents": 6, "batch": {"values": [1]},
                    "prompt_tokens": {"loguniform": [16, 60]},
                    "max_new_tokens": {"values": [1, 2, 4]}, "shape_seed": 0, "block": 3,
                    "stratify_by": {"prefill_tokens": 1.0, "decode_steps": 20.0}},
}


def cell(config: str, mix: str, **over):
    c = {"config": config, "traffic": mix, "rate_per_s": 12.0,
         "slo_fit": {"k0_s": 0.005, "k1_s_per_prompt_token": 1e-5, "k2_s_per_new_token": 0.004},
         "trace_seconds": 0.5,
         "check": {"served_tokens": 40, "logit_gap": 0.08}}
    c.update(over)
    return c


CELLS = {"tiny-dense.tiny-open": cell("tiny-dense", "tiny-open"),
         "tiny-moe.tiny-open": cell("tiny-moe", "tiny-open", check={
             "served_tokens": 40, "logit_gap": 0.08, "route_deficit": 0.25}),
         "tiny-dense.tiny-closed": cell("tiny-dense", "tiny-closed")}


def make(dst: Path) -> Path:
    """Copy the benchmark under ``dst`` and add the tiny cells; returns the
    copy's ``portbench`` directory (its BENCHMARK.json beside it)."""
    root = dst / "portbench"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    for name, cfg in TINY.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps(
            {"name": name, "source": "test size", "reference": "decoder", **cfg}))
        bench["configs"].append({"name": name, "source": "test size",
                                 "file": f"portbench/configs/{name}.json", "reduced": [],
                                 "why": "test size"})
    for name, mix in MIXES.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, c in CELLS.items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(c))
        bench["workloads"].append({"name": name, "config": c["config"], "traffic": c["traffic"],
                                   "chips": 1, "why": "test size"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                kind = "classify" if c["traffic"] == "tiny-open" else "longdoc"
                if any(w.endswith(kind) for w in m["workloads"]):
                    m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
