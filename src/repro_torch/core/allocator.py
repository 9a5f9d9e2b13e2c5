"""Shabari's Resource Allocator (paper §4), ported from
``repro/core/allocator.py``.

``OnlineCSC`` is the cost-sensitive one-against-all multi-class
classifier (Vowpal Wabbit's ``csoaa``): per class a linear regressor
predicts the cost of assigning that class; the arg-min class wins, ties
going to the first index. Updates are online least-squares steps with
AdaGrad per-coordinate rates.

``ResourceAllocator`` owns two agents per function -- one for vCPUs, one
for memory -- plus the paper's safeguards:

* confidence thresholds -- predictions are used only after the agent has
  observed ``conf`` invocations (memory threshold = 2x vCPU threshold);
  until then a large default allocation lets the agent learn safely;
* memory floor -- the predicted allocation is never below the input
  object size; otherwise the default maximum is used (§4.3.2).

Two engines implement the same agents and serve identical allocations:
``"arena"`` (default; stacked, deferred, batched updates in
:class:`repro_torch.core.agent_arena.ArenaEngine`) and ``"legacy"`` (one
tiny ``OnlineCSC`` per function and resource, updated eagerly).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.agent_arena import ArenaEngine, _csc_predict, _csc_update
from repro_torch.core.cost_functions import (
    MEM_CLASS_MB,
    Observation,
    absolute_vcpu_costs,
    memory_costs,
)

DEFAULT_VCPU_CLASSES = 32
DEFAULT_MEM_CLASSES = 40  # 40 x 128 MB = 5 GB
DEFAULT_VCPUS = 10  # learning-phase default (§6)
DEFAULT_MEM_CLASS = 32  # 32 x 128 MB = 4 GB default max (§7.2)
VCPU_CONFIDENCE = 10  # 8-12 sufficed for every function (§7.5)
MEM_CONFIDENCE = 2 * VCPU_CONFIDENCE


@dataclasses.dataclass(frozen=True)
class Allocation:
    vcpus: int
    mem_mb: int
    # True only when the agent is past its confidence threshold AND its
    # prediction survived the safeguards
    vcpu_predicted: bool = False
    mem_predicted: bool = False

    @property
    def predicted(self) -> bool:
        """True only when BOTH resources come from past-confidence agents."""
        return self.vcpu_predicted and self.mem_predicted


class OnlineCSC:
    """Cost-sensitive one-against-all online classifier (legacy engine:
    one small computation per call)."""

    def __init__(self, n_classes: int, dim: int, lr: float = 0.5, *,
                 device="cuda"):
        self.n_classes = n_classes
        self.dim = dim
        self.lr = float(lr)
        self.device = torch.device(device)
        self.w = torch.zeros((n_classes, dim + 1), dtype=torch.float32,
                             device=self.device)
        self.g2 = torch.zeros_like(self.w)
        self.updates = 0

    def _x(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.float32)).to(self.device)

    def predict_lazy(self, x: np.ndarray) -> torch.Tensor:
        """Arg-min class as a 0-d device tensor, without a host sync: the
        caller converts it (``int(...)``) where it consumes the index, so
        two agents' predictions are issued before either waits."""
        return torch.argmin(_csc_predict(self.w, self._x(x)))

    def update(self, x: np.ndarray, costs: np.ndarray) -> None:
        self.w, self.g2 = _csc_update(
            self.w, self.g2, self._x(x),
            torch.from_numpy(np.asarray(costs, np.float32)).to(self.device),
            self.lr,
        )
        self.updates += 1


@dataclasses.dataclass
class _FunctionAgents:
    vcpu: OnlineCSC
    mem: OnlineCSC


class ResourceAllocator:
    """Per-function online agents + defaults + safeguards (paper §4)."""

    def __init__(
        self,
        *,
        n_vcpu_classes: int = DEFAULT_VCPU_CLASSES,
        n_mem_classes: int = DEFAULT_MEM_CLASSES,
        vcpu_confidence: int = VCPU_CONFIDENCE,
        mem_confidence: int = MEM_CONFIDENCE,
        default_vcpus: int = DEFAULT_VCPUS,
        default_mem_class: int = DEFAULT_MEM_CLASS,
        vcpu_cost_fn: Callable = absolute_vcpu_costs,
        mem_class_mb: int = MEM_CLASS_MB,
        engine: str = "arena",
        device="cuda",
    ):
        if engine not in ("arena", "legacy"):
            raise ValueError(f"unknown allocator engine {engine!r}")
        self.n_vcpu_classes = n_vcpu_classes
        self.n_mem_classes = n_mem_classes
        self.vcpu_confidence = vcpu_confidence
        self.mem_confidence = mem_confidence
        self.default_vcpus = default_vcpus
        self.default_mem_class = default_mem_class
        self.vcpu_cost_fn = vcpu_cost_fn
        self.mem_class_mb = mem_class_mb
        self.engine = engine
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ResourceAllocator: no CUDA device; pass "
                               "device='cpu' to run the agents on the CPU")
        self._agents: Dict[str, _FunctionAgents] = {}
        self._arena: Optional[ArenaEngine] = None
        if engine == "arena":
            self._arena = ArenaEngine(
                n_vcpu_classes=n_vcpu_classes,
                n_mem_classes=n_mem_classes,
                vcpu_cost_fn=vcpu_cost_fn,
                mem_class_mb=mem_class_mb,
                device=self.device,
            )

    # ------------------------------------------------------------------
    def _get(self, function: str, dim: int) -> _FunctionAgents:
        ag = self._agents.get(function)
        if ag is None:
            ag = _FunctionAgents(
                vcpu=OnlineCSC(self.n_vcpu_classes, dim, device=self.device),
                mem=OnlineCSC(self.n_mem_classes, dim, device=self.device),
            )
            self._agents[function] = ag
        return ag

    def _finish_allocation(
        self,
        vcpu_class: Optional[int],
        mem_class: Optional[int],
        input_size_mb: float,
    ) -> Allocation:
        """Predicted classes (or None while below confidence) -> served
        allocation, applying the defaults and the §4.3.2 memory floor."""
        if vcpu_class is not None:
            vcpus, vcpu_predicted = vcpu_class + 1, True
        else:
            vcpus, vcpu_predicted = self.default_vcpus, False
        if mem_class is not None:
            mem_mb, mem_predicted = (mem_class + 1) * self.mem_class_mb, True
            # the allocation must exceed the input object size; the
            # default it falls back to is not a prediction
            if mem_mb < input_size_mb:
                mem_mb = self.default_mem_class * self.mem_class_mb
                mem_predicted = False
        else:
            mem_mb = self.default_mem_class * self.mem_class_mb
            mem_predicted = False
        return Allocation(vcpus=vcpus, mem_mb=mem_mb,
                          vcpu_predicted=vcpu_predicted,
                          mem_predicted=mem_predicted)

    def allocate(
        self, function: str, features: np.ndarray, input_size_mb: float = 0.0
    ) -> Allocation:
        """Predict (vcpus, memory) for one invocation (paper Fig. 5 step 3);
        timed by the span ``allocator.allocate``."""
        with tracing.span("allocator.allocate"):
            if self._arena is not None:
                uv, um = self._arena.updates(function)
                v_cls, m_cls = self._arena.predict(
                    function, features,
                    uv >= self.vcpu_confidence, um >= self.mem_confidence)
                return self._finish_allocation(v_cls, m_cls, input_size_mb)
            ag = self._get(function, len(features))
            want_v = ag.vcpu.updates >= self.vcpu_confidence
            want_m = ag.mem.updates >= self.mem_confidence
            v_lazy = ag.vcpu.predict_lazy(features) if want_v else None
            m_lazy = ag.mem.predict_lazy(features) if want_m else None
            return self._finish_allocation(
                int(v_lazy) if v_lazy is not None else None,
                int(m_lazy) if m_lazy is not None else None,
                input_size_mb,
            )

    def allocate_batch(
        self, items: Sequence[Tuple[str, np.ndarray, float]]
    ) -> List[Allocation]:
        """Allocations for a microbatch of (function, features,
        input_size_mb), each identical to the sequential path's."""
        if self._arena is None:
            return [self.allocate(*it) for it in items]
        wants = []
        for fn, x, _ in items:
            uv, um = self._arena.updates(fn)
            wants.append((fn, x, uv >= self.vcpu_confidence,
                          um >= self.mem_confidence))
        classes = self._arena.predict_batch(wants)
        return [
            self._finish_allocation(v_cls, m_cls, items[i][2])
            for i, (v_cls, m_cls) in enumerate(classes)
        ]

    def feedback(self, function: str, features: np.ndarray, obs: Observation) -> None:
        """Close the loop with the daemon's observation (Fig. 5 step 5).
        Arena engine: the update is queued and applied before the next
        prediction that could observe it. Timed by the span
        ``allocator.feedback``."""
        with tracing.span("allocator.feedback"):
            if self._arena is not None:
                self._arena.enqueue_update(function, features, obs)
                return
            ag = self._get(function, len(features))
            ag.vcpu.update(features, self.vcpu_cost_fn(obs, self.n_vcpu_classes))
            ag.mem.update(
                features, memory_costs(obs, self.n_mem_classes, self.mem_class_mb)
            )

    def flush(self) -> None:
        """Apply any deferred feedback now (arena engine)."""
        if self._arena is not None:
            self._arena.flush()

    def release(self, function: str) -> None:
        """Drop a function's agents (arena: frees the rows for reuse)."""
        if self._arena is not None:
            self._arena.release(function)
        else:
            self._agents.pop(function, None)

    def agent_updates(self, function: str) -> Tuple[int, int]:
        if self._arena is not None:
            return self._arena.updates(function)
        ag = self._agents.get(function)
        return (ag.vcpu.updates, ag.mem.updates) if ag else (0, 0)
