"""Per-worker daemon (paper §6): utilization sampling + completion events.

On the real testbed this is two threads — a 10 ms cgroup sampler and a
completion watcher that gRPCs (exec time, cold-start latency, vCPU/mem
utilization series) to the metadata store. In our runtime the simulator
(or the real serving engine) produces the utilization series; the daemon
reduces it to the maxima the cost functions consume and pushes the
record, closing the feedback loop (Fig. 5 step 5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.cost_functions import Observation
from repro_torch.core.metadata_store import InvocationRecord, MetadataStore

SAMPLE_INTERVAL_S = 0.010  # 10 ms cgroup sampling


@dataclasses.dataclass
class UtilizationTrace:
    """What the sampler captured over one invocation's lifetime."""

    vcpu_samples: np.ndarray  # fraction of a core, per sample
    mem_samples_mb: np.ndarray

    @property
    def max_vcpus(self) -> float:
        return float(np.max(self.vcpu_samples)) if self.vcpu_samples.size else 0.0

    @property
    def max_mem_mb(self) -> float:
        return float(np.max(self.mem_samples_mb)) if self.mem_samples_mb.size else 0.0


class WorkerDaemon:
    def __init__(self, store: MetadataStore):
        self.store = store

    def report_completion(
        self,
        *,
        function: str,
        invocation_id: int,
        features: np.ndarray,
        exec_time_s: float,
        slo_s: float,
        alloc_vcpus: int,
        alloc_mem_mb: int,
        trace: UtilizationTrace,
        finish_time: float,
        cold_start: bool,
        oom_killed: bool = False,
    ) -> Observation:
        obs = Observation(
            exec_time_s=exec_time_s,
            slo_s=slo_s,
            alloc_vcpus=alloc_vcpus,
            max_vcpus_used=trace.max_vcpus,
            alloc_mem_mb=alloc_mem_mb,
            max_mem_used_mb=trace.max_mem_mb,
            cold_start=cold_start,
            oom_killed=oom_killed,
        )
        self.store.push(
            InvocationRecord(
                function=function,
                invocation_id=invocation_id,
                features=features,
                observation=obs,
                finish_time=finish_time,
            )
        )
        return obs


# deterministic per-length envelopes, cached: a simulation synthesizes
# one trace per completion, and recomputing linspace + the ramp shapes
# dominated the per-finish cost. Values are identical to the uncached
# computation; only the rng jitter differs per call.
_ENVELOPE_CACHE: dict = {}
_ENVELOPE_CACHE_MAX = 512  # FIFO-evicted; ~16 MB worst case


def _envelopes(n: int):
    env = _ENVELOPE_CACHE.get(n)
    if env is None:
        if len(_ENVELOPE_CACHE) >= _ENVELOPE_CACHE_MAX:
            _ENVELOPE_CACHE.pop(next(iter(_ENVELOPE_CACHE)))
        t = np.linspace(0.0, 1.0, n)
        cpu = np.minimum(1.0, np.minimum(t / 0.1 + 1e-3, (1 - t) / 0.1 + 1e-3))
        mem = np.minimum(1.0, t / 0.3 + 0.2)
        env = (cpu, mem)
        _ENVELOPE_CACHE[n] = env
    return env


def synth_trace(max_vcpus: float, max_mem_mb: float, exec_time_s: float,
                rng: np.random.Generator) -> UtilizationTrace:
    """Build a plausible 10 ms-sampled utilization series whose maxima are
    the given values (ramp-up, plateau with jitter, ramp-down)."""
    n = max(int(exec_time_s / SAMPLE_INTERVAL_S), 4)
    n = min(n, 4096)  # cap the series length for very long invocations
    envelope, mem_envelope = _envelopes(n)
    jitter = 1.0 - 0.05 * rng.random(n)
    v = max_vcpus * envelope * jitter
    m = max_mem_mb * mem_envelope * (1 - 0.02 * rng.random(n))
    # force exact maxima
    if n:
        v[np.argmax(v)] = max_vcpus
        m[np.argmax(m)] = max_mem_mb
    return UtilizationTrace(vcpu_samples=v, mem_samples_mb=m)
