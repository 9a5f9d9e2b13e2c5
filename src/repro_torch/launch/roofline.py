"""Roofline terms and the model-FLOPs estimate (port of the roofline half
of ``repro/launch/hlo_analysis.py``, :138-200, verbatim).

The other half of that module, ``collective_stats`` / ``count_hlo_ops``,
parses XLA's optimized HLO text for collective traffic. The port has no
HLO text, and one card runs no collective, so it is not ported; the dry
run passes ``per_device_collective_bytes=0`` on the one-card mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_global: float
    hlo_bytes_global: float
    collective_bytes_global: float
    model_flops: float
    useful_flops_ratio: float
    dominant: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_terms(
    *,
    per_device_flops: float,
    per_device_bytes: float,
    per_device_collective_bytes: float,
    chips: int,
    model_flops: float,
    peak_flops: float,
    hbm_bw: float,
    link_bw: float,
) -> Roofline:
    compute_s = per_device_flops / peak_flops
    memory_s = per_device_bytes / hbm_bw
    collective_s = per_device_collective_bytes / link_bw
    terms = {
        "compute": compute_s,
        "memory": memory_s,
        "collective": collective_s,
    }
    dominant = max(terms, key=terms.get)
    g_flops = per_device_flops * chips
    return Roofline(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        hlo_flops_global=g_flops,
        hlo_bytes_global=per_device_bytes * chips,
        collective_bytes_global=per_device_collective_bytes * chips,
        model_flops=model_flops,
        useful_flops_ratio=model_flops / g_flops if g_flops else 0.0,
        dominant=dominant,
    )


def model_flops_estimate(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params,
    D = tokens processed by the step)."""
    from repro_torch.configs.base import decoder_seq_len

    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * decoder_seq_len(cfg, shape)
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * decoder_seq_len(cfg, shape)
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
