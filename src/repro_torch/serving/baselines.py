"""Resource-management policies: Shabari + the paper's five baselines (§7.1).

* Static-Medium / Static-Large — fixed (12 vCPU, 3 GB) / (20 vCPU, 5 GB)
  per function, OpenWhisk-style memory-centric scheduling.
* Parrotfish — offline parametric regression on two representative
  inputs; picks the memory minimizing cost (GB-s) with PROPORTIONAL
  vCPUs (bound resource types), fixed thereafter.
* Aquatope — uncertainty-aware Bayesian optimization per function over
  the decoupled (vCPU, mem) space on the same two representative inputs;
  fixed thereafter; runs on Shabari's scheduler (fair comparison, §7.1).
* Cypress — input-SIZE-only linear regression of execution time;
  single-threaded assumption (<=2 vCPUs), batch-oriented memory sizing.
* Shabari — the paper's system: per-invocation online CSOAA prediction
  per resource type + cold-start-aware scheduling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.allocator import Allocation, ResourceAllocator
from repro_torch.core.cost_functions import Observation
from repro_torch.core.featurizer import Featurizer
from repro_torch.serving.profiles import FunctionProfile, input_size_mb
from repro_torch.serving.simulator import InvocationResult, Policy, Simulator
from repro_torch.serving.workload import Arrival

MEM_CLASS_MB = 128
VCPUS_PER_GB = 4.0  # platform binding for bound-resource-type baselines


# ---------------------------------------------------------------------------
def representative_inputs(pool: List[Dict]) -> Tuple[Dict, Dict]:
    """Medium and large representative inputs (Parrotfish/Aquatope, §7.1)."""
    return pool[len(pool) // 2], pool[-1]


class StaticPolicy(Policy):
    uses_shabari_scheduler = False
    placement = "hashing"

    def __init__(self, vcpus: int, mem_mb: int, name: str):
        self.vcpus = vcpus
        self.mem_mb = mem_mb
        self.name = name
        # one shared Allocation: the decision never varies and nothing
        # downstream mutates it, so per-invocation construction is churn
        self._alloc = Allocation(vcpus=vcpus, mem_mb=mem_mb)

    def allocate(self, arrival, meta, sim):
        return self._alloc


class ParrotfishPolicy(Policy):
    """Offline cost-optimal memory via parametric regression; vCPUs bound
    proportionally. ~25 min of profiling per function in the paper —
    we charge the same profiling invocations in benchmarks/overheads."""

    name = "parrotfish"
    uses_shabari_scheduler = False
    placement = "hashing"

    def __init__(self, profiles: Dict[str, FunctionProfile],
                 pool: Dict[str, List[Dict]], seed: int = 0):
        self.alloc_table: Dict[str, Allocation] = {}
        rng = np.random.default_rng(seed)
        mem_grid_mb = [512, 1024, 2048, 3072, 4096, 5120, 6144, 8192]
        for fn, prof in profiles.items():
            med, large = representative_inputs(pool[fn])
            best, best_cost = None, np.inf
            for mem in mem_grid_mb:
                vcpus = max(1, int(round(mem / 1024 * VCPUS_PER_GB)))
                # parametric regression fit == profile samples (5 each)
                times = []
                for m in (med, large):
                    times += [prof.exec_time(m, vcpus, rng) for _ in range(5)]
                t = float(np.mean(times))
                needed = max(prof.mem_used_mb(med), prof.mem_used_mb(large))
                if needed > mem:
                    continue  # OOM at this size
                cost = mem / 1024.0 * t  # GB-seconds
                if cost < best_cost:
                    best, best_cost = Allocation(vcpus, mem, True, True), cost
            if best is None:
                best = Allocation(20, 8192)
            self.alloc_table[fn] = best

    def allocate(self, arrival, meta, sim):
        return self.alloc_table[arrival.function]


class AquatopePolicy(Policy):
    """BO over decoupled (vCPU, mem) per function on two representative
    inputs: 30 uncertainty-aware trials of an EI-style acquisition on a
    noisy objective = SLO compliance with resource-cost regularizer.
    Decisions are per FUNCTION (input-agnostic) — the paper's critique."""

    name = "aquatope"
    uses_shabari_scheduler = True
    placement = "hashing"

    def __init__(self, profiles: Dict[str, FunctionProfile],
                 pool: Dict[str, List[Dict]],
                 slo_fn: Callable[[str, int], float],
                 trials: int = 30, seed: int = 0):
        self.alloc_table: Dict[str, Allocation] = {}
        rng = np.random.default_rng(seed)
        for fn, prof in profiles.items():
            med, large = representative_inputs(pool[fn])
            idx_med = pool[fn].index(med)
            idx_large = pool[fn].index(large)
            slo = min(slo_fn(fn, idx_med), slo_fn(fn, idx_large))
            samples: List[Tuple[int, int, float]] = []

            def objective(v, m):
                # noisy evaluation, as on a real cluster
                times = [prof.exec_time(x, v, rng) for x in (med, large)
                         for _ in range(2)]
                t = float(np.mean(times)) + 0.5 * float(np.std(times))
                mem_need = max(prof.mem_used_mb(med), prof.mem_used_mb(large))
                pen = 100.0 if m < mem_need else 0.0
                sl = 10.0 * max(t - slo, 0.0) / slo
                return sl + pen + 0.02 * v + 0.01 * m / 1024.0

            # BO-style: seeded random exploration then local refinement
            best, best_y = None, np.inf
            for i in range(trials):
                if best is None or i < trials // 2:
                    v = int(rng.integers(1, 33))
                    m = int(rng.integers(2, 65)) * MEM_CLASS_MB
                else:
                    bv, bm = best
                    v = int(np.clip(bv + rng.integers(-4, 5), 1, 32))
                    m = int(np.clip(bm + rng.integers(-8, 9) * MEM_CLASS_MB,
                                    256, 8192))
                y = objective(v, m)
                if y < best_y:
                    best, best_y = (v, m), y
            self.alloc_table[fn] = Allocation(best[0], best[1], True, True)

    def allocate(self, arrival, meta, sim):
        return self.alloc_table[arrival.function]


class CypressPolicy(Policy):
    """Input-size-aware batching system. Linear regression of exec time on
    input SIZE only; assumes single-threaded functions (<=2 vCPUs);
    memory sized for the predicted batch (multiples of a per-invocation
    share — poor utilization under sparse arrivals, §7.2)."""

    name = "cypress"
    uses_shabari_scheduler = False
    placement = "hashing"
    BATCH_TARGET = 4

    def __init__(self, profiles: Dict[str, FunctionProfile],
                 pool: Dict[str, List[Dict]], seed: int = 0):
        self.profiles = profiles
        # online LR state per function: sum stats for y = a*size + b
        self._lr: Dict[str, np.ndarray] = {}
        self._mem_obs: Dict[str, float] = {}
        self.pool = pool

    def _predict_exec(self, fn: str, size: float) -> float:
        st = self._lr.get(fn)
        if st is None or st[4] < 5:
            return 1.0
        n, sx, sy, sxy, _ = st[4], st[0], st[1], st[2], None
        sxx = st[3]
        denom = n * sxx - sx * sx
        if abs(denom) < 1e-9:
            return sy / n
        a = (n * sxy - sx * sy) / denom
        b = (sy - a * sx) / n
        return max(a * size + b, 0.05)

    def _update_lr(self, fn: str, size: float, t: float) -> None:
        st = self._lr.setdefault(fn, np.zeros(5))
        st[0] += size
        st[1] += t
        st[2] += size * t
        st[3] += size * size
        st[4] += 1

    def allocate(self, arrival, meta, sim):
        fn = arrival.function
        mem_share = self._mem_obs.get(fn, 512.0)
        # container sized for a batch of invocations (batch-oriented
        # provisioning) even when arrivals are sparse
        mem = int(math.ceil(self.BATCH_TARGET * mem_share / MEM_CLASS_MB)
                  ) * MEM_CLASS_MB
        return Allocation(vcpus=2, mem_mb=min(mem, 16 * 1024),
                          vcpu_predicted=True, mem_predicted=True)

    def feedback(self, arrival, meta, result, sim):
        fn = arrival.function
        self._update_lr(fn, input_size_mb(fn, meta), result.exec_s)
        prev = self._mem_obs.get(fn, 512.0)
        self._mem_obs[fn] = 0.8 * prev + 0.2 * max(result.used_mem_mb, 64.0)


class ShabariPolicy(Policy):
    """The paper's system: delayed per-invocation decisions.

    ``engine`` selects the allocator implementation: ``"arena"``
    (default, the batched agent arena — see ``repro_torch.core.agent_arena``)
    or ``"legacy"`` (one small computation per per-function agent per
    event). Allocations and metrics are bit-identical either way
    (pinned by the legacy-engine golden snapshot); only wall-clock
    differs. ``device`` is where the agents' weights live and their
    predicts and updates run: ``"cuda"`` by default, ``"cpu"`` only
    when asked; without a card the default raises."""

    name = "shabari"
    uses_shabari_scheduler = True
    placement = "hashing"

    def __init__(self, *, vcpu_cost_fn=None, vcpu_confidence: int = 10,
                 mem_confidence: Optional[int] = None,
                 default_vcpus: int = 10, n_vcpu_classes: int = 32,
                 engine: str = "arena", device="cuda"):
        from repro_torch.core.cost_functions import absolute_vcpu_costs

        kwargs = dict(
            vcpu_confidence=vcpu_confidence,
            mem_confidence=(mem_confidence if mem_confidence is not None
                            else 2 * vcpu_confidence),
            default_vcpus=default_vcpus,
            n_vcpu_classes=n_vcpu_classes,
            vcpu_cost_fn=vcpu_cost_fn or absolute_vcpu_costs,
            engine=engine,
            device=device,
        )
        self.allocator = ResourceAllocator(**kwargs)
        self.featurizer = Featurizer()
        self._features: Dict[int, np.ndarray] = {}
        # same-timestamp arrivals prefetched by begin_arrival_batch:
        # invocation_id -> (Allocation, aux)
        self._prealloc: Dict[int, Tuple[Allocation, tuple]] = {}

    def _featurize(self, arrival, meta, sim):
        fn = arrival.function
        x = self.featurizer.extract(fn, sim.profiles[fn].input_type, meta)
        return x, input_size_mb(fn, meta)

    def allocate_with_aux(self, arrival, meta, sim, aux=None):
        pre = self._prealloc.pop(arrival.invocation_id, None)
        if pre is not None:
            alloc, aux = pre
            self._features[arrival.invocation_id] = aux[0]
            return alloc, aux
        if aux is None:
            # first sight of this invocation: featurize once; the tuple
            # rides the retry payload so re-allocations (the legacy
            # per-retry path) never re-run Featurizer / input_size_mb
            aux = self._featurize(arrival, meta, sim)
        x, size = aux
        self._features[arrival.invocation_id] = x
        return self.allocator.allocate(arrival.function, x, size), aux

    def allocate(self, arrival, meta, sim):
        return self.allocate_with_aux(arrival, meta, sim)[0]

    def begin_arrival_batch(self, items, sim):
        """Featurize in event order (the Featurizer's running stats are
        order-sensitive), then serve every first allocation of this
        timestamp with one fused arena predict."""
        batch = []
        for arrival, meta in items:
            aux = self._featurize(arrival, meta, sim)
            batch.append((arrival.invocation_id, arrival.function, aux))
        allocs = self.allocator.allocate_batch(
            [(fn, aux[0], aux[1]) for _, fn, aux in batch]
        )
        for (iid, fn, aux), alloc in zip(batch, allocs):
            self._prealloc[iid] = (alloc, aux)

    def forget(self, arrival):
        self._features.pop(arrival.invocation_id, None)
        self._prealloc.pop(arrival.invocation_id, None)

    def feedback(self, arrival, meta, result, sim):
        x = self._features.pop(arrival.invocation_id, None)
        if x is None:
            return
        obs = Observation(
            exec_time_s=result.finish_t - result.arrival_t,
            slo_s=result.slo_s,
            alloc_vcpus=result.alloc_vcpus,
            max_vcpus_used=result.used_vcpus,
            alloc_mem_mb=result.alloc_mem_mb,
            max_mem_used_mb=result.used_mem_mb,
            cold_start=result.cold_start,
            oom_killed=result.oom_killed,
        )
        self.allocator.feedback(arrival.function, x, obs)


class FormulationPolicy(ShabariPolicy):
    """Shabari with one of the §4.2 ML formulations (Figure 6)."""

    uses_shabari_scheduler = True

    def __init__(self, mode: str, profiles: Dict[str, FunctionProfile],
                 *, device="cuda"):
        super().__init__(device=device)
        from repro_torch.core.featurizer import FEATURE_SCHEMAS
        from repro_torch.core.formulations import FormulationAllocator

        self.name = f"shabari-{mode}"
        fns = sorted(profiles.keys())
        dims = {f: len(FEATURE_SCHEMAS[profiles[f].input_type]) for f in fns}
        types = {f: profiles[f].input_type for f in fns}
        self.allocator = FormulationAllocator(mode, fns, dims, types,
                                              device=device)


# ---------------------------------------------------------------------------
# SLO table (§7.1: isolated profiling, 1.4x best-allocation median)
# ---------------------------------------------------------------------------


def build_slo_table(
    profiles: Dict[str, FunctionProfile],
    pool: Dict[str, List[Dict]],
    *,
    multiplier: float = 1.4,
    max_vcpus: int = 32,
    runs: int = 5,
    seed: int = 1234,
) -> Dict[Tuple[str, int], float]:
    rng = np.random.default_rng(seed)
    table: Dict[Tuple[str, int], float] = {}
    for fn, prof in profiles.items():
        for idx, meta in enumerate(pool[fn]):
            best = np.inf
            for v in (1, 2, 4, 8, 12, 16, 20, 24, 28, 32):
                if v > max_vcpus:
                    break
                times = [prof.exec_time(meta, v, rng) for _ in range(runs)]
                best = min(best, float(np.median(times)))
            table[(fn, idx)] = multiplier * best
    return table
