"""Shabari core: the featurizer, the cost functions, the online allocator
(agent arena included), and the cluster side the simulator drives: the
metadata store, the cold-start-aware scheduler and the front-door router."""

from repro_torch.core.allocator import Allocation, OnlineCSC, ResourceAllocator
from repro_torch.core.cost_functions import (
    Observation,
    absolute_vcpu_costs,
    memory_costs,
    proportional_vcpu_costs,
)
from repro_torch.core.featurizer import Featurizer
from repro_torch.core.metadata_store import MetadataStore
from repro_torch.core.router import Router
from repro_torch.core.scheduler import ShabariScheduler

__all__ = [
    "OnlineCSC",
    "ResourceAllocator",
    "Allocation",
    "Featurizer",
    "Observation",
    "Router",
    "ShabariScheduler",
    "MetadataStore",
    "absolute_vcpu_costs",
    "proportional_vcpu_costs",
    "memory_costs",
]
