"""Meshes and hardware constants of the port's launch tooling (port of
``repro/launch/mesh.py``).

A mesh here is an :class:`AbstractMesh`: the reference's axis names and
sizes, and no devices. :func:`make_production_mesh` gives the reference's
production meshes, (16, 16) over ("data", "model") and (2, 16, 16) over
("pod", "data", "model"), for the sharding rules and the dry run's
per-device plans; :func:`one_gpu_mesh` is the (1, 1) mesh of the card the
port runs on. Placing tensors across several GPUs (DTensor) waits for a
machine with more than one card (ROADMAP.md).

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, at the card's full 700 W power limit); none is a TPU's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PEAK_FLOPS_BF16 = 989e12   # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink bytes/s, each way
CARD_HBM_BYTES = 80e9      # the data sheet's 80 GB


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices (``mesh.shape[name]`` is a size)."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def label(self) -> str:
        return "x".join(str(s) for s in self.axis_sizes)


def make_production_mesh(multi_pod: bool = False) -> AbstractMesh:
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def one_gpu_mesh() -> AbstractMesh:
    return AbstractMesh(("data", "model"), (1, 1))


MESHES = {"1x1": one_gpu_mesh, "16x16": make_production_mesh,
          "2x16x16": lambda: make_production_mesh(multi_pod=True)}


def card_memory_bytes() -> float:
    """The card's memory where a card is present, else the data sheet's."""
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return CARD_HBM_BYTES
