"""Cost functions for the online CSOAA agents (paper §4.3.1-§4.3.2).

The port's own copy of ``repro/core/cost_functions.py`` (pure NumPy):
importing the reference module would import JAX through
``repro/core/__init__.py``.

Given one completed invocation's observation, produce the per-class cost
vector used to update the agent. The lowest cost is 1; costs grow
linearly away from the target class, with underpredictions (classes
below the target) penalized more steeply than overpredictions.

vCPU variants (Figure 7a):

* Absolute  — every X=0.5 s of SLO violation adds one vCPU class above
  the maximum actually utilized; every Y=1.5 s of slack removes one.
  More aggressive after violations (the variant the paper ships).
* Proportional — scales the current class by exec_time/SLO.

When the SLO was violated but the invocation used <90% of its allocated
vCPUs, the violation is attributed to external factors (contention,
infeasible SLO), and the target is the class actually utilized — NOT a
larger one (this is what keeps single-threaded functions from inflating,
Figure 9b).

Memory (§4.3.2): no SLO feature (no swap — allocation doesn't change
speed, it only must exceed utilization); target = observed utilization
class; underprediction penalty is steeper (OOM kills the invocation).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

ABS_X_SECONDS = 0.5  # violation seconds per +1 vCPU class
ABS_Y_SECONDS = 1.5  # slack seconds per -1 vCPU class
HIGH_UTIL_THRESHOLD = 0.9
UNDER_SLOPE = 3.0  # cost slope below the target class
OVER_SLOPE = 1.0  # cost slope above the target class
MEM_UNDER_SLOPE = 6.0  # OOM is worse than an SLO miss
MEM_CLASS_MB = 128  # one class = 128 MB (paper) / 256 MB HBM (TPU mode)


@dataclasses.dataclass(frozen=True, slots=True)
class Observation:
    """What the worker daemon reports for one completed invocation."""

    exec_time_s: float
    slo_s: float
    alloc_vcpus: int
    max_vcpus_used: float
    alloc_mem_mb: int
    max_mem_used_mb: float
    cold_start: bool = False
    oom_killed: bool = False

    @property
    def slo_met(self) -> bool:
        return self.exec_time_s <= self.slo_s

    @property
    def vcpu_util(self) -> float:
        return self.max_vcpus_used / max(self.alloc_vcpus, 1)


def _linear_costs(n_classes: int, target_idx: int,
                  under_slope: float = UNDER_SLOPE,
                  over_slope: float = OVER_SLOPE) -> np.ndarray:
    idx = np.arange(n_classes, dtype=np.float64)
    below = np.maximum(target_idx - idx, 0.0)
    above = np.maximum(idx - target_idx, 0.0)
    return 1.0 + under_slope * below + over_slope * above


def _clamp(i: int, n: int) -> int:
    return max(0, min(n - 1, i))


def absolute_vcpu_costs(obs: Observation, n_classes: int) -> np.ndarray:
    """Classes are vCPU counts 1..n_classes; index c => c+1 vCPUs."""
    cur = _clamp(obs.alloc_vcpus - 1, n_classes)
    used = _clamp(int(math.ceil(obs.max_vcpus_used)) - 1, n_classes)
    if obs.slo_met:
        # vCPUs beyond those utilized cannot have contributed to meeting
        # the SLO (Figure 9b: sentiment never inflates) — start from the
        # utilized class, then the slack says how much further down is
        # safe: one class per Y seconds of slack.
        slack = obs.slo_s - obs.exec_time_s
        down = int(slack / ABS_Y_SECONDS)
        target = min(cur, used) - down
    else:
        if obs.vcpu_util < HIGH_UTIL_THRESHOLD:
            # violation not caused by the allocation — external factors
            target = used
        else:
            violation = obs.exec_time_s - obs.slo_s
            up = 1 + int(violation / ABS_X_SECONDS)
            target = used + up
    return _linear_costs(n_classes, _clamp(target, n_classes))


def proportional_vcpu_costs(obs: Observation, n_classes: int) -> np.ndarray:
    cur = _clamp(obs.alloc_vcpus - 1, n_classes)
    used = _clamp(int(math.ceil(obs.max_vcpus_used)) - 1, n_classes)
    if obs.slo_met:
        scale = obs.exec_time_s / max(obs.slo_s, 1e-9)
        target = int(math.ceil((min(cur, used) + 1) * scale)) - 1
    else:
        if obs.vcpu_util < HIGH_UTIL_THRESHOLD:
            target = used
        else:
            scale = obs.exec_time_s / max(obs.slo_s, 1e-9)
            target = int(math.ceil((used + 1) * scale)) - 1
            target = max(target, used + 1)
    return _linear_costs(n_classes, _clamp(target, n_classes))


def memory_costs(obs: Observation, n_classes: int,
                 class_mb: int = MEM_CLASS_MB) -> np.ndarray:
    """Classes are memory sizes: index c => (c+1)*class_mb MB."""
    if obs.oom_killed:
        # All we know: the true need exceeds the allocation.
        target = _clamp(int(math.ceil(obs.alloc_mem_mb / class_mb)), n_classes)
    else:
        target = _clamp(
            int(math.ceil(obs.max_mem_used_mb / class_mb)) - 1, n_classes
        )
    return _linear_costs(n_classes, target, under_slope=MEM_UNDER_SLOPE)


# ---------------------------------------------------------------------------
# Batched variants (agent-arena flush path)
#
# One call produces the (k, n_classes) cost matrix for k completed
# invocations — the microbatch the arena applies in a single fused
# update. Each row is BIT-IDENTICAL to the corresponding per-observation
# function above (same float64 arithmetic, element-wise; asserted by
# tests/test_torch_allocator.py), so deferring cost computation to flush
# time cannot change a single update.
# ---------------------------------------------------------------------------


def _linear_costs_batch(n_classes: int, targets: np.ndarray,
                        under_slope: float = UNDER_SLOPE,
                        over_slope: float = OVER_SLOPE) -> np.ndarray:
    idx = np.arange(n_classes, dtype=np.float64)[None, :]
    t = targets.astype(np.float64)[:, None]
    below = np.maximum(t - idx, 0.0)
    above = np.maximum(idx - t, 0.0)
    return 1.0 + under_slope * below + over_slope * above


def _clamp_batch(i: np.ndarray, n: int) -> np.ndarray:
    return np.clip(i, 0, n - 1)


def _trunc_div(a: np.ndarray, b: float) -> np.ndarray:
    """``int(a / b)`` per element: truncation toward zero, matching the
    scalar path's Python ``int()`` (np.floor_divide would round down)."""
    return np.trunc(a / b).astype(np.int64)


def absolute_vcpu_costs_batch(observations, n_classes: int) -> np.ndarray:
    obs = list(observations)
    exec_s = np.array([o.exec_time_s for o in obs], np.float64)
    slo_s = np.array([o.slo_s for o in obs], np.float64)
    alloc = np.array([o.alloc_vcpus for o in obs], np.int64)
    used_f = np.array([o.max_vcpus_used for o in obs], np.float64)
    util = np.array([o.vcpu_util for o in obs], np.float64)
    cur = _clamp_batch(alloc - 1, n_classes)
    used = _clamp_batch(np.ceil(used_f).astype(np.int64) - 1, n_classes)
    met = exec_s <= slo_s
    down = _trunc_div(slo_s - exec_s, ABS_Y_SECONDS)
    up = 1 + _trunc_div(exec_s - slo_s, ABS_X_SECONDS)
    target = np.where(
        met,
        np.minimum(cur, used) - down,
        np.where(util < HIGH_UTIL_THRESHOLD, used, used + up),
    )
    return _linear_costs_batch(n_classes, _clamp_batch(target, n_classes))


def proportional_vcpu_costs_batch(observations, n_classes: int) -> np.ndarray:
    obs = list(observations)
    exec_s = np.array([o.exec_time_s for o in obs], np.float64)
    slo_s = np.array([o.slo_s for o in obs], np.float64)
    alloc = np.array([o.alloc_vcpus for o in obs], np.int64)
    used_f = np.array([o.max_vcpus_used for o in obs], np.float64)
    util = np.array([o.vcpu_util for o in obs], np.float64)
    cur = _clamp_batch(alloc - 1, n_classes)
    used = _clamp_batch(np.ceil(used_f).astype(np.int64) - 1, n_classes)
    met = exec_s <= slo_s
    scale = exec_s / np.maximum(slo_s, 1e-9)
    met_target = np.ceil((np.minimum(cur, used) + 1) * scale).astype(np.int64) - 1
    viol_target = np.maximum(
        np.ceil((used + 1) * scale).astype(np.int64) - 1, used + 1
    )
    target = np.where(
        met,
        met_target,
        np.where(util < HIGH_UTIL_THRESHOLD, used, viol_target),
    )
    return _linear_costs_batch(n_classes, _clamp_batch(target, n_classes))


def memory_costs_batch(observations, n_classes: int,
                       class_mb: int = MEM_CLASS_MB) -> np.ndarray:
    obs = list(observations)
    alloc = np.array([o.alloc_mem_mb for o in obs], np.float64)
    used = np.array([o.max_mem_used_mb for o in obs], np.float64)
    oom = np.array([o.oom_killed for o in obs], bool)
    target = np.where(
        oom,
        np.ceil(alloc / class_mb).astype(np.int64),
        np.ceil(used / class_mb).astype(np.int64) - 1,
    )
    return _linear_costs_batch(
        n_classes, _clamp_batch(target, n_classes),
        under_slope=MEM_UNDER_SLOPE,
    )


# per-observation → batched lookup for configurable cost callables
BATCHED_COST_FNS = {
    absolute_vcpu_costs: absolute_vcpu_costs_batch,
    proportional_vcpu_costs: proportional_vcpu_costs_batch,
    memory_costs: memory_costs_batch,
}
