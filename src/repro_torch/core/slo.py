"""Performance-centric interface: per-invocation SLOs (paper §3, §7.1).

Shabari's interface lets every invocation carry its own execution-time
SLO. The evaluation sets SLO = multiplier x median isolated execution
time at the best vCPU count (1..32) for that (function, input) — a much
tighter bar than Cypress's max+20%. ``SLORegistry`` computes and caches
these from the function profiles, mirroring §7.1's isolated profiling
runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

DEFAULT_SLO_MULTIPLIER = 1.4  # the paper's default (Figure 13 sweeps it)


@dataclasses.dataclass(frozen=True)
class InvocationRequest:
    """What a client submits: function, input, SLO (Fig. 5 step 1)."""

    function: str
    input_type: str
    meta: Dict
    slo_s: float
    object_id: str = ""
    input_size_mb: float = 0.0


class SLORegistry:
    """SLO = multiplier x best-allocation median isolated exec time."""

    def __init__(
        self,
        isolated_exec_time: Callable[[str, Dict, int], float],
        *,
        multiplier: float = DEFAULT_SLO_MULTIPLIER,
        max_vcpus: int = 32,
        profile_runs: int = 5,
    ):
        self._exec = isolated_exec_time
        self.multiplier = multiplier
        self.max_vcpus = max_vcpus
        self.profile_runs = profile_runs
        self._cache: Dict[Tuple[str, str], float] = {}

    def slo_for(self, function: str, input_key: str, meta: Dict) -> float:
        key = (function, input_key)
        if key not in self._cache:
            best = np.inf
            for v in range(1, self.max_vcpus + 1):
                times = [
                    self._exec(function, meta, v) for _ in range(self.profile_runs)
                ]
                best = min(best, float(np.median(times)))
            self._cache[key] = self.multiplier * best
        return self._cache[key]
