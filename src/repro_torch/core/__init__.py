"""Shabari core, as far as the serving slice needs it: the featurizer,
the cost functions and the online allocator (agent arena included)."""

from repro_torch.core.allocator import Allocation, OnlineCSC, ResourceAllocator
from repro_torch.core.cost_functions import (
    Observation,
    absolute_vcpu_costs,
    memory_costs,
    proportional_vcpu_costs,
)
from repro_torch.core.featurizer import Featurizer

__all__ = [
    "OnlineCSC",
    "ResourceAllocator",
    "Allocation",
    "Featurizer",
    "Observation",
    "absolute_vcpu_costs",
    "proportional_vcpu_costs",
    "memory_costs",
]
