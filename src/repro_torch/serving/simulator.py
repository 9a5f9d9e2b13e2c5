"""Discrete-event cluster simulator — the stand-in for the paper's
17-node OpenWhisk testbed (§7.1).

The policies, allocator, featurizer, scheduler, daemon, and metadata
store are the REAL implementations from ``repro_torch.core``; the simulator
only supplies what the hardware supplied in the paper: time, utilization
and contention. Modeled effects, each tied to a paper observation:

* cold starts: container create latency grows with container size;
* vCPU contention: when the sum of ACTIVE parallel demand on a worker
  exceeds its physical cores, co-located invocations slow down
  proportionally (why static-large still violates SLOs, §7.2);
* network contention: object-store-fed functions (matmult, lrtrain,
  imageprocess, compress, ...) share a 10 Gb NIC per worker — the effect
  that sinks Hermod-style packing (Figure 7b);
* OOM kills: an invocation whose footprint exceeds its allocation dies
  partway through (§4.3.2 safeguards exist because of this);
* queueing + timeouts: invocations that cannot be placed retry and
  eventually time out (the §7.5 oversubscription study). The
  Allocation — and the policy's featurization cache (aux) — is decided
  ONCE at first arrival and carried through retries; timed-out
  invocations report it without re-entering the policy (pre-fix
  behavior behind ``SimConfig.legacy_retry_alloc``).

Event-loop microbatching: consecutive same-timestamp arrivals are
popped together and offered to ``Policy.begin_arrival_batch`` before
being processed in order, so a learning policy (the agent arena,
``repro_torch.core.agent_arena``) serves them with one fused predict
dispatch; pending agent updates always flush before any prediction for
the same function, keeping served allocations bit-identical to the
sequential path.

``SimConfig(n_clusters=N)`` scales the testbed to N such clusters
behind a front-door :class:`repro_torch.core.router.Router`; ``routing``
picks one of four policies — home-cluster ``hashing``, cold-start-aware
``spill-over`` (default), completion-time-estimate ``estimate``
(minimum-ECT placement including still-warming containers within
``estimate_horizon_s``, calibrated online from observed exec times),
and ``random``. The simulator feeds the estimator via
``Router.observe_exec`` at every completion and commits estimate-mode
``Decision.pending`` bindings (busy + reservation on a warming
container, start at its ``warm_at``).

Resource lifecycle: capacity is acquired at PLACEMENT, not at start — a
placed cold start reserves its container's (vcpus, mem) for the whole
warm-up window, so ``Worker.fits`` and ``Router._load`` see committed-
but-warming capacity (``SimConfig.legacy_acquire`` restores the old
acquire-on-start accounting for A/B). ``SimConfig.admission`` adds
front-door admission control (shed / queue) under fleet-wide overload.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster, Container, Worker
from repro_torch.core.cost_functions import Observation
from repro_torch.core.daemon import (SAMPLE_INTERVAL_S, UtilizationTrace,
                               WorkerDaemon, synth_trace)
from repro_torch.core.fleet import COLD_JITTER_SIGMA, FleetSpec, MachineType
from repro_torch.core.image_cache import (ImageCacheSpec, NodeImageCache,
                                    default_images)
from repro_torch.core.metadata_store import InvocationRecord, MetadataStore
from repro_torch.serving.event_queue import CalendarQueue
from repro_torch.serving.profiles import FunctionProfile, base_function, input_size_mb
from repro_torch.serving.workload import Arrival

# functions that pull inputs over the network from the object store (§5)
NETWORK_FED = {"matmult", "lrtrain", "imageprocess", "compress",
               "videoprocess", "speech2text", "resnet50", "mobilenet"}
NIC_GBPS = 10.0


@dataclasses.dataclass
class SimConfig:
    n_workers: int = 16  # workers PER CLUSTER (total = n_workers * n_clusters)
    vcpus_per_worker: int = 90
    physical_cores: int = 96
    mem_mb_per_worker: int = 125 * 1024
    vcpu_limit: int = 90
    cold_base_s: float = 0.45
    cold_per_gb_s: float = 0.12
    sched_overhead_s: float = 0.001
    retry_interval_s: float = 0.5
    queue_timeout_s: float = 300.0
    keep_alive_s: float = 600.0
    seed: int = 0
    # How co-runner contention is applied to an invocation:
    #   "snapshot" (default) — the slowdown is computed ONCE at start
    #     time from the co-runners active at that instant and held for
    #     the invocation's whole run. This is the original semantics;
    #     with it, metrics match the pre-refactor per-event scan.
    #   "dynamic" — the slowdown is re-evaluated whenever a co-runner
    #     starts or finishes on the same worker: remaining work is
    #     rescaled and the finish event re-queued. Closer to real
    #     cgroup CPU-share behavior; metrics differ from snapshot.
    contention_mode: str = "snapshot"
    # Compatibility switch for A/B benchmarking (benchmarks/sim_bench):
    # restore the pre-refactor O(N) loops — the per-event scan over
    # every running invocation for contention demand, and the
    # per-schedule scan over every container for warm lookups — instead
    # of the incremental per-worker aggregates and per-function index.
    # Metrics are identical either way; only speed differs. Only
    # meaningful with contention_mode="snapshot".
    legacy_scans: bool = False
    # Multi-cluster front door (repro_torch.core.router): number of clusters
    # behind the router and the routing policy applied per arrival —
    # "hashing" | "spill-over" | "estimate" | "random". With
    # n_clusters=1 the first, second, and fourth degenerate to the
    # single-cluster path; "estimate" does NOT degenerate — its
    # warming-soon binding (below) still short-circuits cold starts
    # inside one cluster.
    n_clusters: int = 1
    routing: str = "spill-over"
    # Estimate-mode horizon (SECONDS): a still-warming uncommitted
    # container whose warm_at lies within this many seconds of the
    # arrival is a placement target — the invocation binds to it
    # (Decision.pending), the runtime reserves its capacity, and it
    # starts the moment the container turns warm, paying the residual
    # warm-up instead of a full cold start. Larger horizons trade
    # certain short waits against speculative cold starts; the default
    # covers the full cold-start range of the paper's container sizes
    # (~0.5-1.3 s). Read only when routing == "estimate".
    estimate_horizon_s: float = 1.5
    # Compatibility switch for A/B benchmarking (benchmarks/sim_bench):
    # restore the pre-fix retry path — one policy.allocate (an agent
    # predict on the allocator's device for learning policies) per
    # 0.5 s RETRY of a queued invocation, run even when the invocation
    # is about to time out — instead of caching the Allocation in the
    # retry payload.
    legacy_retry_alloc: bool = False
    # Resource lifecycle (benchmarks/admission_bench A/B). Default is
    # acquire-on-PLACEMENT: a cold-started invocation reserves its
    # container's (vcpus, mem) the moment it is placed, so Worker.fits,
    # the per-worker aggregates, and Router._load all see committed-but-
    # warming capacity; the reservation converts to a running
    # acquisition when the cold start completes and is released if the
    # invocation's queue timeout lapses first. legacy_acquire=True
    # restores acquire-on-START (capacity held only once the container
    # is warm), under which arrivals inside the warm-up window see a
    # free-looking worker and stack cold starts onto it.
    legacy_acquire: bool = False
    # Router-level admission control. The load-headroom modes act under
    # fleet-wide overload — when EVERY cluster's committed load exceeds
    # admission_headroom, "shed" drops the arrival at the front door
    # (recorded as a shed result, an SLO violation) and "queue" holds
    # it in the front-door retry queue without probing any scheduler.
    # "slo" is the SLO-native mode: ignore load headroom and instead
    # shed exactly the invocations whose minimum completion-time
    # estimate across clusters already exceeds their remaining SLO
    # budget — work that cannot be served in time no matter where it
    # lands (uncalibrated functions are always admitted). "none"
    # (default) admits everything, as before.
    admission: str = "none"
    admission_headroom: float = 0.95
    # Per-input exec estimation (the tentpole of the SLO-native PR):
    # when True (default), the feature vector + input size a policy
    # caches in its retry aux (the Featurizer output ShabariPolicy
    # already computes) feed the router's per-function online regressor
    # (repro_torch.core.ect), so estimate routing and SLO admission see
    # heavy-tail inputs coming instead of forecasting the EWMA mean for
    # every invocation. False restores the input-blind EWMA-only
    # estimator for A/B (benchmarks/estimate_bench). Policies that
    # cache no features (the static/offline baselines) always use the
    # EWMA path regardless.
    estimate_features: bool = True
    # Heterogeneous fleet + network topology (repro_torch.core.fleet). None
    # (default) builds the uniform fleet the flags above describe —
    # n_clusters x n_workers of one machine type mirroring
    # physical_cores / vcpus_per_worker / vcpu_limit /
    # mem_mb_per_worker / cold_base_s / cold_per_gb_s / NIC_GBPS, with
    # zero-cost links — and is bit-identical to pre-fleet behavior. An
    # explicit FleetSpec OVERRIDES those per-worker/per-cluster flags
    # entirely (each Worker takes its MachineType's shape; note this
    # includes the OpenWhisk-baseline vcpu_limit override in
    # repro_torch.serving.experiment, which is a no-op under an explicit
    # fleet) and charges arrival→cluster input-payload transfer time on
    # remote placements over non-free links.
    fleet: Optional[FleetSpec] = None
    # Compatibility switch for A/B benchmarking (benchmarks/sim_bench
    # scale tier) and equality testing (tests/test_event_loop.py):
    # restore the pre-refactor hot loop — one global heapq over every
    # event (arrivals pre-pushed, so a 24 h trace seeds a million-entry
    # heap) and the full synth_trace utilization series per completion —
    # instead of the array-backed loop (arrival stream kept as a sorted
    # array, calendar-bucketed queue for scheduled events, slim daemon
    # path that draws the identical rng stream without materializing
    # samples nobody reads). Metrics and goldens are byte-identical
    # either way; only speed differs. The same flush-before-read
    # discipline applies on both paths (pending agent updates flush
    # before any same-function prediction).
    legacy_event_loop: bool = False
    # Estimate-mode A/B for the fleet refactor: when True (default) the
    # router PRICES the same input-payload transfer time the simulator
    # charges on remote placements (plus each machine's cold curve and
    # exec-speed factor — those are always priced via Worker.machine).
    # False makes estimate routing transfer-BLIND: it scores remote
    # clusters as if spilling were free, the pre-fleet assumption
    # (benchmarks/fleet_bench gates the gap). No effect on what the
    # simulator charges.
    estimate_transfer: bool = True
    # Locality-aware cold starts (repro_torch.core.image_cache): an
    # ImageCacheSpec attaches a finite per-node layer store to every
    # worker and cold latency becomes pull-what's-missing — the
    # registry fetch of the image's non-resident layers (over the
    # machine's registry_gbps downlink) overlapped with the classic
    # cold curve. ImageCacheSpec(affinity=True) additionally ranks
    # cold placement by residual pull and prices it in estimate
    # routing; affinity=False keeps decisions cache-blind (the A/B
    # arm, benchmarks/registry_bench). The None default is the flat
    # -constant cold model with a zero-overhead fast path: no cache
    # objects, no per-arrival lookups, rng stream untouched — every
    # pre-existing golden is byte-identical.
    image_cache: Optional[ImageCacheSpec] = None
    # Function-chain/DAG workloads (repro_torch.serving.chains): a tuple of
    # ChainSpec makes every trace arrival of a spec's trigger function
    # start a chain instance — upstream completions spawn downstream
    # stage arrivals (join barriers wait for ALL parents; the child's
    # input is the pool entry nearest the summed in-edge payloads), and
    # per-stage SLO budgets come from the chain's END-TO-END SLO
    # instead of the per-invocation slo_table. The None default is a
    # zero-overhead fast path (no runtime object, no per-event hooks'
    # work, rng stream untouched): every pre-existing golden is
    # byte-identical.
    chains: Optional[Tuple] = None
    # How the end-to-end budget decomposes into per-stage allowances:
    # "aware" (default) reserves the longest expected path below the
    # stage (critical-path slack analysis) and feeds the remaining
    # budget to estimate routing as ``budget_s``; "uniform" is the
    # slack-blind A/B arm — the e2e SLO split evenly over the critical
    # path's depth, no routing budget (benchmarks/chain_bench).
    chain_slack: str = "aware"
    # Fifer-style proactive scaling: when the running stage-N
    # invocations feeding a stage-N+1 function outnumber its idle
    # warm+warming containers on its home cluster, launch one
    # uncommitted warming container (the existing warming-soon index)
    # sized from the function's last allocation. Read only when
    # ``chains`` is set.
    chain_prewarm: bool = True


@dataclasses.dataclass(slots=True)
class InvocationResult:
    invocation_id: int
    function: str
    arrival_t: float
    start_t: float = 0.0
    finish_t: float = 0.0
    exec_s: float = 0.0
    slo_s: float = 0.0
    alloc_vcpus: int = 0
    alloc_mem_mb: int = 0
    used_vcpus: float = 0.0
    used_mem_mb: float = 0.0
    cold_start: bool = False
    cold_latency_s: float = 0.0
    queued_s: float = 0.0
    oom_killed: bool = False
    timed_out: bool = False
    shed: bool = False  # rejected by router admission control

    @property
    def slo_violated(self) -> bool:
        if self.timed_out or self.oom_killed or self.shed:
            return True
        return (self.finish_t - self.arrival_t) > self.slo_s + 1e-9

    @property
    def wasted_vcpus(self) -> float:
        return max(self.alloc_vcpus - self.used_vcpus, 0.0)

    @property
    def wasted_mem_mb(self) -> float:
        return max(self.alloc_mem_mb - self.used_mem_mb, 0.0)


class Policy:
    """Interface each resource-management system implements."""

    name = "base"
    uses_shabari_scheduler = True

    def allocate(self, arrival: Arrival, meta: Dict, sim: "Simulator"):
        raise NotImplementedError

    def allocate_with_aux(self, arrival: Arrival, meta: Dict,
                          sim: "Simulator", aux=None):
        """``allocate`` plus an opaque per-invocation cache. The
        simulator threads ``aux`` through the retry payload alongside
        the cached Allocation, so any path that re-enters allocation
        (``SimConfig.legacy_retry_alloc``) reuses the first attempt's
        featurized input + input size instead of re-running the
        Featurizer every 0.5 s retry."""
        return self.allocate(arrival, meta, sim), aux

    def begin_arrival_batch(self, items: List[Tuple[Arrival, Dict]],
                            sim: "Simulator") -> None:
        """Hook: all same-timestamp arrivals that need a first
        allocation, in event order. Learning policies prefetch them as
        one fused microbatched prediction (the agent arena); the
        default is a no-op and each arrival allocates individually."""
        pass

    def feedback(self, arrival: Arrival, meta: Dict, result: InvocationResult,
                 sim: "Simulator") -> None:
        pass

    def forget(self, arrival: Arrival) -> None:
        """Drop any per-invocation state cached by ``allocate``. Called
        instead of ``feedback`` when the invocation times out in the
        queue and will never run — without it, per-invocation caches
        (e.g. feature vectors) leak for the run's lifetime."""
        pass


@dataclasses.dataclass(slots=True)
class _Running:
    result: InvocationResult
    container: Container
    worker: Worker
    demand_vcpus: float
    net_gbps: float
    arrival: Optional[Arrival] = None
    meta: Optional[Dict] = None
    # uncontended exec seconds sampled at start — fed to the router's
    # estimator calibration (Router.observe_exec) at finish
    base_exec: float = 0.0
    # the invocation's feature vector + input MB (from the policy's aux
    # cache), carried to finish so calibration trains the per-input
    # regressor on the SAME vector the allocation saw
    features: Optional[object] = None
    input_mb: Optional[float] = None
    # dynamic-contention bookkeeping: seconds of uncontended work left,
    # the slowdown currently applied, when it was last re-evaluated, and
    # a generation counter that invalidates superseded finish events.
    base_remaining: float = 0.0
    slow: float = 1.0
    last_t: float = 0.0
    gen: int = 0


class Simulator:
    def __init__(
        self,
        *,
        policy: Policy,
        profiles: Dict[str, FunctionProfile],
        input_pool: Dict[str, List[Dict]],
        slo_table: Dict[Tuple[str, int], float],
        cfg: Optional[SimConfig] = None,
    ):
        self.cfg = cfg or SimConfig()
        self.policy = policy
        self.profiles = profiles
        self.input_pool = input_pool
        self.slo_table = slo_table
        self.rng = np.random.default_rng(self.cfg.seed)
        # resolve the fleet: an explicit FleetSpec wins; otherwise build
        # the uniform fleet the scalar flags describe, so every layer
        # below reads hardware from Worker.machine either way
        if self.cfg.fleet is not None:
            self.fleet = self.cfg.fleet
        else:
            self.fleet = FleetSpec.uniform(
                self.cfg.n_clusters, self.cfg.n_workers,
                MachineType(
                    physical_cores=self.cfg.physical_cores,
                    vcpus=self.cfg.vcpus_per_worker,
                    mem_mb=self.cfg.mem_mb_per_worker,
                    nic_gbps=NIC_GBPS,
                    cold_base_s=self.cfg.cold_base_s,
                    cold_per_gb_s=self.cfg.cold_per_gb_s,
                    vcpu_limit=self.cfg.vcpu_limit,
                ),
            )
        # transfer charging is skipped entirely on free topologies (the
        # default): no per-arrival home-cluster hash, no extra events —
        # the event stream is bit-identical to pre-fleet behavior
        self._charge_transfer = not self.fleet.topology.is_free()
        self.clusters = [
            Cluster(
                legacy_scans=self.cfg.legacy_scans,
                machines=spec.worker_machines(),
            )
            for spec in self.fleet.clusters
        ]
        # worker ids become globally unique across clusters: the
        # simulator keys per-worker state (_worker_running) by wid.
        # Schedulers index workers by list position, so single-cluster
        # behavior is unchanged (wid == position for cluster 0).
        n_total_workers = 0
        for cl in self.clusters:
            for w in cl.workers:
                w.wid = n_total_workers
                n_total_workers += 1
        from repro_torch.core.router import Router
        from repro_torch.core.scheduler import ShabariScheduler

        # locality-aware cold starts: resolve the image catalog and
        # attach one NodeImageCache per worker. The None default does
        # NOTHING here — one boolean, no cache objects, no per-arrival
        # work — so the disabled path stays byte-identical (goldens)
        # and full-speed (sim_bench scale tier).
        ic = self.cfg.image_cache
        self._image_cache_active = ic is not None
        self._images = None
        image_resolver = None
        if self._image_cache_active:
            if ic.images is not None:
                self._images = dict(ic.images)
            elif self.fleet.images:
                self._images = dict(self.fleet.images)
            else:
                self._images = default_images(sorted(self.profiles))
            pinned: Tuple[str, ...] = ()
            if ic.pin_base and self._images:
                # pin the universal base: layers present in EVERY image
                digsets = [set(im.digests) for im in self._images.values()]
                pinned = tuple(sorted(set.intersection(*digsets)))
            for cl in self.clusters:
                for w in cl.workers:
                    w.image_cache = NodeImageCache(
                        w.machine.image_store_mb,
                        w.machine.registry_gbps, pinned=pinned)
            if ic.affinity:
                # scheduler ranks cold placement by residual pull and
                # the router prices it; affinity=False leaves both
                # cache-blind while the runtime still charges pulls
                image_resolver = self._images.__getitem__
        placement = getattr(policy, "placement", "hashing")
        shabari_sched = getattr(policy, "uses_shabari_scheduler", True)
        self.schedulers = [
            ShabariScheduler(
                cl, placement=placement,
                keep_alive_s=self.cfg.keep_alive_s,
                route_larger=shabari_sched, background_launch=shabari_sched,
                image_resolver=image_resolver,
            )
            for cl in self.clusters
        ]
        self.router = Router(
            self.clusters, self.schedulers,
            routing=self.cfg.routing, seed=self.cfg.seed,
            admission=self.cfg.admission,
            admission_headroom=self.cfg.admission_headroom,
            estimate_features=self.cfg.estimate_features,
            estimate_horizon_s=self.cfg.estimate_horizon_s,
            sched_overhead_s=self.cfg.sched_overhead_s,
            # the router forecasts from the SAME per-worker MachineType
            # (cold curve, cores, NIC, exec factor) and Topology this
            # simulator charges — the §5 constants have one source now
            topology=self.fleet.topology,
            price_transfer=self.cfg.estimate_transfer,
            # clone aliases (fn::k) share estimator state: calibration
            # is keyed by base function, so cold-storm's clones learn
            # one model instead of each relearning from scratch
            pool_key=base_function,
            network_fed=lambda fn: base_function(fn) in NETWORK_FED,
            image_resolver=image_resolver,
        )
        # single-cluster aliases (the common case, and what most tests
        # and benchmarks reach for)
        self.cluster = self.clusters[0]
        self.scheduler = self.schedulers[0]
        self.store = MetadataStore()
        self.daemon = WorkerDaemon(self.store)
        self.results: List[InvocationResult] = []
        self.container_sizes: Dict[str, set] = {}
        self._events: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._running: Dict[int, _Running] = {}
        # per-worker index of running invocations (dynamic-mode retiming
        # touches only the affected worker's co-runners)
        self._worker_running: List[Dict[int, _Running]] = [
            {} for _ in range(n_total_workers)
        ]
        self.dynamic = self.cfg.contention_mode == "dynamic"
        assert self.cfg.contention_mode in ("snapshot", "dynamic")
        self.events_processed = 0
        self.now = 0.0
        # array-backed loop state: the calendar queue replaces the
        # global heap while _run_fast is active (None = legacy heap);
        # the slim daemon path replays synth_trace's exact rng draws
        # without materializing utilization samples nobody reads
        self._queue: Optional[CalendarQueue] = None
        self._retry_q: Optional[deque] = None
        self._slim_daemon = not self.cfg.legacy_event_loop
        self._rng_advance = isinstance(self.rng.bit_generator,
                                       np.random.PCG64)
        self._zero_feat = np.zeros(1, np.float32)
        self._run_pool: List[_Running] = []
        # function chains (repro_torch.serving.chains): None stays a single
        # is-None check on the hot paths — no runtime, no hooks' work
        self._chains = None
        self._chain_iid = None
        self._chain_alloc: Dict[str, Tuple[int, int]] = {}
        if self.cfg.chains:
            from repro_torch.serving.chains import ChainRuntime
            self._chains = ChainRuntime(
                self.cfg.chains, self.input_pool,
                slack=self.cfg.chain_slack)

    # ------------------------------------------------------------ events
    def _push(self, t: float, kind: str, payload) -> None:
        ev = (t, next(self._seq), kind, payload)
        q = self._queue
        if q is not None:
            if kind == "arrival":
                # retry lane: every arrival re-push is scheduled at
                # now + retry_interval_s with now non-decreasing and
                # seq strictly increasing, so append order IS (t, seq)
                # order — a deque replaces a heap for the storm-hot
                # event class (_run_fast merges it back in)
                self._retry_q.append(ev)
            else:
                q.push(ev)
        else:
            heapq.heappush(self._events, ev)

    # ------------------------------------------------------------ helpers
    def cold_latency(self, vcpus: int, mem_mb: int,
                     machine: Optional[MachineType] = None) -> float:
        """Container-create latency on ``machine`` (the target worker's
        hardware; default-fleet machines mirror the SimConfig curve)."""
        m = machine if machine is not None else self.fleet.clusters[0].machines[0][0]
        jitter = float(self.rng.lognormal(0.0, COLD_JITTER_SIGMA))
        return m.cold_latency_s(mem_mb) * jitter

    def _cold_latency_at(self, w: Worker, function: str,
                         vcpus: int, mem_mb: int) -> float:
        """Cold latency for creating ``function``'s container on worker
        ``w``: the classic jittered create cost, overlapped with the
        registry pull of whatever image layers ``w`` is missing (the
        pull mutates the node's cache — this is the charging path, not
        a probe). With ``image_cache=None`` this is exactly the classic
        draw: same rng stream, no cache work."""
        lat = self.cold_latency(vcpus, mem_mb, w.machine)
        if self._image_cache_active:
            lat = max(lat, w.image_cache.pull(self._images[function]))
        return lat

    def _contention(self, w: Worker, fn: str, extra_demand: float,
                    extra_net: float) -> float:
        if self.cfg.legacy_scans:
            # pre-refactor loop, kept for A/B benchmarking (sim_bench)
            demand = extra_demand + sum(
                r.demand_vcpus for r in self._running.values() if r.worker is w
            )
            net = extra_net + sum(
                r.net_gbps for r in self._running.values() if r.worker is w
            )
        else:
            soa, i = w.soa, w.sidx
            demand = extra_demand + float(soa.active_demand_vcpus[i])
            net = extra_net + float(soa.active_net_gbps[i])
        cpu_slow = max(1.0, demand / w.machine.physical_cores)
        net_slow = (max(1.0, net / w.machine.nic_gbps)
                    if base_function(fn) in NETWORK_FED else 1.0)
        return max(cpu_slow, net_slow)

    def _net_demand(self, fn: str, meta: Dict, exec_s: float,
                    nic_gbps: float = NIC_GBPS) -> float:
        if base_function(fn) not in NETWORK_FED or exec_s <= 0:
            return 0.0
        bits = input_size_mb(fn, meta) * 8e6
        return min(bits / 1e9 / max(exec_s, 0.1), nic_gbps)

    def _aux_features(self, aux) -> Tuple[Optional[object], Optional[float]]:
        """The (feature vector, input MB) pair a policy caches in its
        retry aux (ShabariPolicy and subclasses; the static/offline
        baselines cache nothing) — the per-input signal threaded into
        Router.route/observe_exec. Returns (None, None) when the policy
        caches no features or SimConfig(estimate_features=False) turned
        the per-input estimator off."""
        if (self.cfg.estimate_features and isinstance(aux, tuple)
                and len(aux) == 2 and isinstance(aux[0], np.ndarray)):
            return aux[0], float(aux[1])
        return None, None

    # ------------------------------------------------------------ handlers
    def _record_terminal(self, arrival: Arrival, alloc, first_seen: float,
                         *, timed_out: bool = False,
                         shed: bool = False) -> None:
        """Record an invocation that will never run (queue timeout,
        front-door shed, cancelled cold start) and drop the policy's
        per-invocation state."""
        now = self.now
        res = InvocationResult(
            invocation_id=arrival.invocation_id, function=arrival.function,
            arrival_t=first_seen, start_t=now, finish_t=now,
            slo_s=self.slo_table[(arrival.function, arrival.input_idx)],
            alloc_vcpus=alloc.vcpus, alloc_mem_mb=alloc.mem_mb,
            queued_s=now - first_seen, timed_out=timed_out, shed=shed,
        )
        self.results.append(res)
        self.policy.forget(arrival)
        if self._chains is not None:
            # a chain stage that will never run fails its whole chain
            # (the join barriers below it can never be satisfied)
            self._chains.on_fail(arrival.invocation_id)

    def _on_arrival(self, arrival: Arrival, first_seen: float,
                    alloc=None, aux=None) -> None:
        # meta is resolved lazily: a front-door-held retry bounces off
        # the admission fast path below without ever reading its input
        now = self.now
        cfg = self.cfg
        meta = None
        if cfg.legacy_retry_alloc:
            # pre-fix retry path kept for A/B benchmarking (sim_bench):
            # re-predict on every retry, even when about to time out.
            # The featurized input + input size ride the retry payload
            # (aux), so only the PREDICT re-runs — not the Featurizer.
            meta = self.input_pool[arrival.function][arrival.input_idx]
            alloc, aux = self.policy.allocate_with_aux(
                arrival, meta, self, aux)
        if now - first_seen > cfg.queue_timeout_s:
            # the cached allocation from the first attempt is reported;
            # a timed-out invocation never touches the policy again
            if alloc is None:  # only reachable with queue_timeout_s <= 0
                meta = self.input_pool[arrival.function][arrival.input_idx]
                alloc, aux = self.policy.allocate_with_aux(
                    arrival, meta, self, aux)
            self._record_terminal(arrival, alloc, first_seen, timed_out=True)
            return
        if alloc is None:
            meta = self.input_pool[arrival.function][arrival.input_idx]
            alloc, aux = self.policy.allocate_with_aux(arrival, meta, self, aux)
        elif self.router.try_requeue():
            # retry of a front-door-held arrival while the fleet is
            # still past the queue-mode admission headroom: route()
            # would rebuild the same queued decision without touching
            # any scheduler, so skip straight to the re-push (shared by
            # both event loops — bit-identical to the long way around;
            # _push is inlined because retry storms make this the
            # hottest line of a saturated large-fleet simulation)
            ev = (now + cfg.retry_interval_s, next(self._seq), "arrival",
                  (arrival, first_seen, alloc, aux))
            if self._queue is not None:
                self._retry_q.append(ev)  # FIFO retry lane (see _push)
            else:
                heapq.heappush(self._events, ev)
            return
        if meta is None:
            meta = self.input_pool[arrival.function][arrival.input_idx]

        # per-input ECT + SLO-native admission: the router sees the
        # invocation's cached features and its REMAINING SLO budget
        # (queueing already spent counts against it on retries)
        feats, in_mb = self._aux_features(aux)
        slo_s = self.slo_table[(arrival.function, arrival.input_idx)]
        eff_slo = slo_s - (now - first_seen)
        budget_s = None
        if self._chains is not None:
            # chain stages route against the CHAIN's budget, not the
            # flat per-invocation SLO: slack-aware mode also hands the
            # remaining end-to-end allowance to estimate routing as
            # budget_s (None for non-chain traffic / uniform mode).
            # The last-seen allocation per function sizes Fifer
            # pre-warm launches (see _chain_prewarm).
            stage = self._chains.stage_budget(arrival, now, first_seen)
            if stage is not None:
                eff_slo, budget_s = stage
            self._chain_alloc[arrival.function] = (alloc.vcpus, alloc.mem_mb)
        route = self.router.route(arrival.function, alloc, now,
                                  features=feats, input_mb=in_mb,
                                  slo_s=eff_slo, budget_s=budget_s)
        decision = route.decision
        if route.shed:
            # admission control dropped it at the front door: no retry
            self._record_terminal(arrival, alloc, first_seen, shed=True)
            return
        if decision.queued:
            # carry the allocation AND the featurization cache: retries
            # must not re-run the policy or the Featurizer (front-door
            # admission queueing lands here too)
            self._push(now + self.cfg.retry_interval_s, "arrival",
                       (arrival, first_seen, alloc, aux))
            return

        # input-payload transfer (repro/core/fleet.py): the payload
        # lives in the function's HOME cluster's object store, so a
        # remote placement first moves it over the inter-cluster link.
        # The wait lands in queued_s. Free topologies (every default
        # fleet) skip this entirely — no per-arrival home hash, no
        # extra events — so pre-fleet event streams are bit-identical.
        xfer = 0.0
        if self._charge_transfer:
            xfer = self.fleet.topology.transfer_s(
                self.router.home_cluster(arrival.function),
                route.cluster_idx,
                input_size_mb(arrival.function, meta))

        if decision.pending is not None:
            # estimate routing bound this invocation to a still-warming
            # uncommitted container (a §5 case-2 background launch):
            # commit it — mark busy so no other arrival can take it,
            # reserve its capacity (acquire-on-placement, same as a
            # fresh cold start), and start when it turns warm. The
            # invocation pays only the residual warm-up (and, remotely,
            # whatever of the payload transfer the warm-up doesn't hide).
            c = decision.pending
            c.worker.cluster.mark_busy(c)
            if not self.cfg.legacy_acquire:
                c.worker.reserve(c.vcpus, c.mem_mb)
                c.reserved = True
            self._push(max(c.warm_at, now + xfer), "warm_start",
                       (arrival, meta, alloc, c, c.warm_at - now, first_seen,
                        aux))
            return

        cluster = self.clusters[route.cluster_idx]
        if decision.background_launch and decision.container is not None:
            # case 2: larger warm container used; exact size in background
            w, v, m = decision.background_launch
            c = cluster.new_container(
                w, arrival.function, v, m, now,
                warm_at=now + self._cold_latency_at(w, arrival.function, v, m),
            )
            self._note_size(arrival.function, v, m)

        if decision.container is not None:
            c = decision.container
            if xfer > 0.0:
                # warm container on a remote cluster: hold it while the
                # payload crosses the link, then start
                cluster.mark_busy(c)
                c.last_used = now
                self._push(now + xfer, "xfer_start",
                           (arrival, meta, alloc, c, first_seen, aux))
            else:
                self._start(arrival, meta, alloc, c,
                            cold=False, first_seen=first_seen, aux=aux)
        else:
            # cold start: create the container, start when warm (the
            # payload transfer overlaps the warm-up; only the excess
            # beyond the cold latency delays the start)
            w, v, m = decision.background_launch
            lat = self._cold_latency_at(w, arrival.function, v, m)
            c = cluster.new_container(w, arrival.function, v, m, now,
                                      warm_at=now + lat)
            cluster.mark_busy(c)
            if not self.cfg.legacy_acquire:
                # acquire-on-placement: hold the capacity for the whole
                # warm-up window (converted to a running acquisition in
                # _start, released in _cancel_cold_start)
                w.reserve(v, m)
                c.reserved = True
            self._note_size(arrival.function, v, m)
            self._push(now + max(lat, xfer), "warm_start",
                       (arrival, meta, alloc, c, lat, first_seen, aux))

    def _note_size(self, fn: str, v: int, m: int) -> None:
        self.container_sizes.setdefault(fn, set()).add((v, m))

    def _cancel_cold_start(self, arrival: Arrival, alloc, c: Container,
                           first_seen: float) -> None:
        """The cold start outlived the invocation's queue timeout:
        release the reservation and record the timeout. The container
        itself survives as an idle warm container — the capacity was
        spent warming it, so future invocations may as well reuse it."""
        c.reserved = False
        c.last_used = self.now
        c.worker.cancel_reservation(c.vcpus, c.mem_mb)
        c.worker.cluster.mark_idle(c)
        self._record_terminal(arrival, alloc, first_seen, timed_out=True)

    def _start(self, arrival, meta, alloc, container: Container, *, cold: bool,
               first_seen: float, cold_latency: float = 0.0,
               aux=None) -> None:
        now = self.now
        fn = arrival.function
        prof = self.profiles[fn]
        w = container.worker
        w.cluster.mark_busy(container)
        container.last_used = now
        if container.reserved:
            # acquire-on-placement: the capacity was reserved when the
            # cold start was placed; convert it instead of re-acquiring
            container.reserved = False
            w.commit_reservation(container.vcpus, container.mem_mb)
        else:
            w.acquire(container.vcpus, container.mem_mb)

        # the invocation runs with the CONTAINER's size (may exceed
        # request). base_exec is REFERENCE-machine uncontended seconds
        # (what profiles model and what calibrates the router's
        # estimator); the worker's exec-speed factor scales it to this
        # machine's uncontended time before contention applies.
        vcpus = container.vcpus
        base_exec, demand = prof.exec_and_demand(meta, vcpus, self.rng)
        eff_exec = base_exec * w.machine.exec_factor
        net = self._net_demand(fn, meta, eff_exec, w.machine.nic_gbps)
        slow = self._contention(w, fn, demand, net)
        exec_s = eff_exec * slow

        mem_used = prof.mem_used_mb(meta)
        oom = mem_used > container.mem_mb
        if oom:
            exec_s *= 0.6  # killed partway

        res = InvocationResult(
            invocation_id=arrival.invocation_id, function=fn,
            arrival_t=first_seen, start_t=now,
            slo_s=self.slo_table[(fn, arrival.input_idx)],
            alloc_vcpus=container.vcpus, alloc_mem_mb=container.mem_mb,
            used_vcpus=min(demand, vcpus),
            used_mem_mb=min(mem_used, container.mem_mb),
            cold_start=cold, cold_latency_s=cold_latency,
            queued_s=now - first_seen - (cold_latency if cold else 0.0),
            oom_killed=oom, exec_s=exec_s,
        )
        feats, in_mb = self._aux_features(aux)
        pool = self._run_pool
        if pool:
            # recycled record (churn cut): every field re-set here
            run = pool.pop()
            run.result = res
            run.container = container
            run.worker = w
            run.demand_vcpus = demand
            run.net_gbps = net
            run.arrival = arrival
            run.meta = meta
            run.base_exec = base_exec
            run.features = feats
            run.input_mb = in_mb
            run.base_remaining = 0.0
            run.slow = 1.0
            run.last_t = 0.0
            run.gen = 0
        else:
            run = _Running(
                result=res, container=container, worker=w,
                demand_vcpus=demand, net_gbps=net, arrival=arrival, meta=meta,
                base_exec=base_exec, features=feats, input_mb=in_mb,
            )
        self._running[arrival.invocation_id] = run
        self._worker_running[w.wid][arrival.invocation_id] = run
        w.add_active(demand, net)
        if self.dynamic:
            # track uncontended work (on THIS machine); the finish event
            # floats as co-runners come and go
            run.base_remaining = eff_exec * (0.6 if oom else 1.0)
            run.slow = slow
            run.last_t = now
            self._push(now + run.base_remaining * slow, "finish",
                       (arrival, meta, run.gen))
            self._retime_worker(w, exclude=arrival.invocation_id)
        else:
            self._push(now + exec_s, "finish", (arrival, meta, 0))
        if self._chains is not None:
            self._chain_prewarm(arrival.invocation_id)

    def _chain_prewarm(self, iid: int) -> None:
        """Fifer-style proactive scaling: a chain stage just STARTED, so
        its children's arrivals are now forecastable. For each child
        function whose running-parent count exceeds its idle
        warm+warming supply on its home cluster, launch ONE uncommitted
        warming container (exactly like a case-2 background launch: it
        enters ``idle_by_function`` with a future ``warm_at``, i.e. the
        warming-soon index estimate routing binds to), sized from the
        function's last-seen allocation. A child function never
        allocated yet is skipped — sizing it would mean running the
        policy out-of-band and perturbing its learning state."""
        counts = self._chains.note_start(iid)
        if not self.cfg.chain_prewarm:
            return
        for child_fn, inflight in counts:
            size = self._chain_alloc.get(child_fn)
            if size is None:
                continue
            ci = self.router.home_cluster(child_fn)
            cl = self.clusters[ci]
            supply = len(cl.idle_by_function.get(child_fn, ()))
            if supply >= inflight:
                continue
            v, m = size
            w = self.schedulers[ci].cold_candidate(child_fn, v, m)
            if w is None:
                continue
            cl.new_container(
                w, child_fn, v, m, self.now,
                warm_at=self.now + self._cold_latency_at(w, child_fn, v, m))
            self._note_size(child_fn, v, m)

    def _retime_worker(self, w: Worker, exclude: int = -1) -> None:
        """Dynamic mode: a co-runner started/finished on ``w`` — advance
        each running invocation's progress under its old slowdown, apply
        the new one, and re-queue its finish (the generation counter
        voids the stale event)."""
        now = self.now
        for iid, r in self._worker_running[w.wid].items():
            if iid == exclude:
                continue
            r.base_remaining = max(
                r.base_remaining - (now - r.last_t) / r.slow, 0.0)
            r.slow = self._contention(w, r.result.function, 0.0, 0.0)
            r.last_t = now
            r.gen += 1
            self._push(now + r.base_remaining * r.slow, "finish",
                       (r.arrival, r.meta, r.gen))

    def _on_finish(self, arrival: Arrival, meta: Dict, gen: int) -> None:
        now = self.now
        run = self._running.get(arrival.invocation_id)
        if run is None or gen != run.gen:
            return  # superseded by a dynamic-contention retime
        del self._running[arrival.invocation_id]
        res, c, w = run.result, run.container, run.worker
        del self._worker_running[w.wid][arrival.invocation_id]
        w.remove_active(run.demand_vcpus, run.net_gbps)
        res.finish_t = now
        if self.dynamic:
            res.exec_s = now - res.start_t
        w.release(c.vcpus, c.mem_mb)
        c.last_used = now
        w.cluster.mark_idle(c)
        self.results.append(res)

        if self._slim_daemon:
            # Array-backed loop's daemon path: nothing downstream reads
            # the UtilizationTrace SAMPLES — only its maxima, which
            # synth_trace forces to exactly (used_vcpus, used_mem_mb)
            # via the argmax write. So draw the identical rng stream
            # (two random(n) batches, same n) to keep the shared
            # generator bit-aligned with the legacy path, and build the
            # Observation/record directly with the interned zero
            # feature vector instead of allocating one per completion.
            n_smp = max(int(res.exec_s / SAMPLE_INTERVAL_S), 4)
            n_smp = min(n_smp, 4096)
            if self._rng_advance:
                # PCG64's random(n) consumes exactly n raw uint64s, so
                # jumping the state 2*n forward is bit-identical to the
                # two jitter batches synth_trace would have drawn —
                # O(log n) instead of generating values nothing reads
                self.rng.bit_generator.advance(2 * n_smp)
            else:
                self.rng.random(n_smp)
                self.rng.random(n_smp)
            obs = Observation(
                exec_time_s=now - res.arrival_t,  # end-to-end vs SLO
                slo_s=res.slo_s,
                alloc_vcpus=res.alloc_vcpus,
                max_vcpus_used=res.used_vcpus,
                alloc_mem_mb=res.alloc_mem_mb,
                max_mem_used_mb=res.used_mem_mb,
                cold_start=res.cold_start,
                oom_killed=res.oom_killed,
            )
            self.store.push(InvocationRecord(
                function=res.function, invocation_id=res.invocation_id,
                features=self._zero_feat, observation=obs,
                finish_time=now,
            ))
        else:
            trace = synth_trace(res.used_vcpus, res.used_mem_mb, res.exec_s,
                                self.rng)
            obs = self.daemon.report_completion(
                function=res.function, invocation_id=res.invocation_id,
                features=np.zeros(1, np.float32),  # policy recomputes if needed
                exec_time_s=now - res.arrival_t,  # end-to-end vs SLO
                slo_s=res.slo_s, alloc_vcpus=res.alloc_vcpus,
                alloc_mem_mb=res.alloc_mem_mb, trace=trace,
                finish_time=now, cold_start=res.cold_start,
                oom_killed=res.oom_killed,
            )
        self.policy.feedback(arrival, meta, res, self)
        # estimator calibration: report the UNCONTENDED exec time and
        # the NIC draw so estimate-mode scoring can apply each
        # candidate's own §5 slowdown without double counting (no-op
        # read path for every other routing policy, so default-mode
        # metrics are untouched). OOM kills ran only a fraction of
        # base_exec, so feeding the full figure would inflate the
        # estimator — skip them.
        if not res.oom_killed:
            self.router.observe_exec(res.function, run.base_exec,
                                     run.net_gbps,
                                     features=run.features,
                                     input_mb=run.input_mb)
        if self._chains is not None:
            ch = self._chains
            ch.note_end(arrival.invocation_id)
            if res.oom_killed:
                ch.on_fail(arrival.invocation_id)
            else:
                # spawn every stage whose LAST parent this completion
                # was: a fresh arrival at t == now, pushed as its own
                # scheduled-event kind so both event loops route it
                # through the calendar/heap (the fast loop's retry
                # deque is arrivals-at-now+interval ONLY — a same-t
                # arrival push would break its ordering invariant)
                for inst, stage, fn_c, idx_c in ch.on_complete(
                        arrival.invocation_id, now):
                    child = Arrival(next(self._chain_iid), now, fn_c, idx_c)
                    ch.bind(inst, stage, child.invocation_id, now)
                    self._push(now, "chain_arrival", child)
        if self.dynamic:
            self._retime_worker(w)  # departures speed co-runners up
        # recycle the bookkeeping record (the result object lives on in
        # self.results; only references are cleared, nothing is mutated)
        run.result = None
        run.container = None
        run.worker = None
        run.arrival = None
        run.meta = None
        run.features = None
        self._run_pool.append(run)

    # ------------------------------------------------------------ run
    def run(self, arrivals: List[Arrival]) -> List[InvocationResult]:
        if self._chains is not None:
            # spawned stage invocations get ids above the trace's
            # 0..n-1 block — unique, deterministic, loop-independent
            self._chain_iid = itertools.count(len(arrivals))
        if self.cfg.legacy_event_loop:
            return self._run_legacy(arrivals)
        return self._run_fast(arrivals)

    def chain_summary(self) -> Optional[Dict[str, float]]:
        """End-to-end chain metrics, None when ``cfg.chains`` is off."""
        return None if self._chains is None else self._chains.summary()

    def _process_arrival_cohort(self, t: float, payloads: list) -> None:
        """Handle one same-timestamp arrival cohort in event order —
        shared by both loops. Microbatching every CONSECUTIVE same-
        timestamp arrival is bit-identical to processing them one by
        one: nothing can be interleaved between them (an intervening
        finish/warm_start would break the cohort), and pending agent
        updates flush before any prediction for the same function."""
        if len(payloads) > 1 and not self.cfg.legacy_retry_alloc:
            fresh = [
                (a, self.input_pool[a.function][a.input_idx])
                for a, fs, alloc, _ in payloads
                if alloc is None
                and t - fs <= self.cfg.queue_timeout_s
            ]
            if len(fresh) > 1:
                self.policy.begin_arrival_batch(fresh, self)
        for arrival, first_seen, alloc, aux in payloads:
            self._on_arrival(arrival, first_seen, alloc, aux)

    def _handle_scheduled(self, t: float, kind: str, payload) -> None:
        """Dispatch one non-arrival, non-reap event (both loops)."""
        if kind == "warm_start":
            arrival, meta, alloc, c, lat, first_seen, aux = payload
            if c.reserved and t - first_seen > self.cfg.queue_timeout_s:
                # reservation outlived the queue timeout (only
                # possible when cold latency > remaining budget)
                self._cancel_cold_start(arrival, alloc, c, first_seen)
            else:
                # container finished cold-starting; run the
                # invocation (_start re-marks busy + commits the
                # reservation / acquires load)
                c.busy = False
                self._start(arrival, meta, alloc, c, cold=True,
                            first_seen=first_seen, cold_latency=lat,
                            aux=aux)
        elif kind == "xfer_start":
            # remote warm placement: the input payload finished
            # crossing the inter-cluster link; run on the warm
            # container that was held for it (_start re-marks busy)
            arrival, meta, alloc, c, first_seen, aux = payload
            c.busy = False
            self._start(arrival, meta, alloc, c, cold=False,
                        first_seen=first_seen, aux=aux)
        elif kind == "chain_arrival":
            # downstream chain stage spawned by an upstream completion
            # (repro_torch.serving.chains): a fresh arrival first seen NOW —
            # it allocates, routes against the chain budget, and
            # retries like any other arrival from here on
            self._on_arrival(payload, t, None, None)
        else:  # finish
            arrival, meta, gen = payload
            self._on_finish(arrival, meta, gen)

    def _run_legacy(self, arrivals: List[Arrival]) -> List[InvocationResult]:
        """Pre-refactor hot loop (``legacy_event_loop=True``): one
        global heapq with every arrival pre-pushed."""
        for a in arrivals:
            self._push(a.t, "arrival", (a, a.t, None, None))
        reap_t = 60.0
        self._push(reap_t, "reap", None)
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            self.now = t
            self.events_processed += 1
            if kind == "arrival":
                payloads = [payload]
                while (self._events and self._events[0][0] == t
                       and self._events[0][2] == "arrival"):
                    payloads.append(heapq.heappop(self._events)[3])
                self.events_processed += len(payloads) - 1
                self._process_arrival_cohort(t, payloads)
            elif kind == "reap":
                for sched in self.schedulers:
                    sched.reap_idle(self.now)
                if self._events:
                    self._push(self.now + 60.0, "reap", None)
            else:
                self._handle_scheduled(t, kind, payload)
        return self.results

    def _run_fast(self, arrivals: List[Arrival]) -> List[InvocationResult]:
        """Array-backed hot loop (the default). The trace's arrivals
        never enter a priority queue: a stable argsort over their
        timestamps IS their pop order (ties keep list order, exactly
        the ``(t, seq)`` order the legacy heap gave them, since legacy
        seqs were assigned in list order). Scheduled events (finish /
        warm_start / xfer_start / reap) go through a bucketed
        :class:`CalendarQueue` whose pop order matches a global heap.
        Retries get a THIRD lane, a plain deque: every arrival re-push
        is scheduled at ``now + retry_interval_s`` with ``now``
        non-decreasing and seq strictly increasing, so append order is
        already ``(t, seq)`` order and no heap is needed for the event
        class that dominates a saturated run. The three streams merge
        on ``(t, seq)``: virtual arrival seqs are their list indices
        (all < n), and ``self._seq`` starts at n, so every scheduled
        event sorts after every same-timestamp fresh arrival — as it
        did under the single heap."""
        n = len(arrivals)
        self._seq = itertools.count(n)  # seqs 0..n-1 belong to arrivals
        self._queue = q = CalendarQueue()
        self._retry_q = rq = deque()
        try:
            if n:
                order = np.argsort(
                    np.array([a.t for a in arrivals], dtype=np.float64),
                    kind="stable",
                ).tolist()
            else:
                order = []
            self._push(60.0, "reap", None)  # seq n, as under the heap
            ai = 0
            while ai < n or q or rq:
                head = q.peek()
                # effective scheduled head = min over both lanes
                head_is_retry = False
                if rq:
                    r = rq[0]
                    if head is None or r[0] < head[0] or (
                            r[0] == head[0] and r[1] < head[1]):
                        head = r
                        head_is_retry = True
                if ai < n:
                    oi = order[ai]
                    a = arrivals[oi]
                    # oi < n <= any queued seq: fresh arrival wins ties
                    if head is None or a.t < head[0] or (
                            a.t == head[0] and oi < head[1]):
                        t = a.t
                        self.now = t
                        ai += 1
                        payloads = [(a, t, None, None)]
                        while ai < n:
                            b = arrivals[order[ai]]
                            if b.t != t:
                                break
                            payloads.append((b, t, None, None))
                            ai += 1
                        # retries at the same t (their seqs all exceed
                        # every fresh arrival's) extend the cohort
                        # while they are the globally next events — a
                        # calendar event at the same t with a smaller
                        # seq breaks the consecutive run, exactly as it
                        # broke the run the heap popped
                        if rq and rq[0][0] == t:
                            ch = q.peek()
                            while rq:
                                r = rq[0]
                                if r[0] != t or (ch is not None
                                                 and ch[0] == t
                                                 and ch[1] < r[1]):
                                    break
                                payloads.append(r[3])
                                rq.popleft()
                        self.events_processed += len(payloads)
                        self._process_arrival_cohort(t, payloads)
                        continue
                if head_is_retry:
                    t, _, _k, payload = rq.popleft()
                    self.now = t
                    self.events_processed += 1
                    nxt = rq[0] if rq else None
                    if nxt is None or nxt[0] != t:
                        # lone retry — the common case in a retry storm
                        # (retry timestamps inherit their arrival's
                        # fractional offset, so they rarely collide);
                        # identical to a single-payload cohort, minus
                        # the list build
                        a, fs, al, ax = payload
                        self._on_arrival(a, fs, al, ax)
                    else:
                        # retry-only cohort: drain same-t retries while
                        # no same-t calendar event with a smaller seq
                        # intervenes (heap-run parity, as above)
                        ch = q.peek()
                        payloads = [payload]
                        while rq:
                            r = rq[0]
                            if r[0] != t or (ch is not None
                                             and ch[0] == t
                                             and ch[1] < r[1]):
                                break
                            payloads.append(r[3])
                            rq.popleft()
                        self.events_processed += len(payloads) - 1
                        self._process_arrival_cohort(t, payloads)
                    continue
                t, _, kind, payload = q.pop()
                self.now = t
                self.events_processed += 1
                if kind == "reap":
                    for sched in self.schedulers:
                        sched.reap_idle(t)
                    if ai < n or q or rq:
                        self._push(t + 60.0, "reap", None)
                else:
                    self._handle_scheduled(t, kind, payload)
        finally:
            self._queue = None
            self._retry_q = None
        return self.results


# ---------------------------------------------------------------------------
# Metrics (the paper's three evaluation axes, §7.1)
# ---------------------------------------------------------------------------


def summarize(results: List[InvocationResult]) -> Dict[str, float]:
    if not results:
        return {}
    viol = [r for r in results if r.slo_violated]
    # waste/utilization are resource-consumption metrics: shed and
    # timed-out invocations never ran (used_*=0 with a real alloc_*
    # from _record_terminal), so including them reports phantom waste
    # for work that never consumed a cycle. They still count in the
    # SLO/shed/timeout rates below.
    ran = [r for r in results if not (r.shed or r.timed_out)]
    wasted_v = np.array([r.wasted_vcpus for r in ran])
    wasted_m = np.array([r.wasted_mem_mb for r in ran])
    util_v = np.array([
        r.used_vcpus / r.alloc_vcpus for r in ran if r.alloc_vcpus
    ])
    util_m = np.array([
        r.used_mem_mb / r.alloc_mem_mb for r in ran if r.alloc_mem_mb
    ])
    colds = [r for r in results if r.cold_start]
    return {
        "n": len(results),
        "slo_violation_pct": 100.0 * len(viol) / len(results),
        "wasted_vcpus_p50": float(np.percentile(wasted_v, 50)) if wasted_v.size else 0.0,
        "wasted_vcpus_p95": float(np.percentile(wasted_v, 95)) if wasted_v.size else 0.0,
        "wasted_mem_mb_p50": float(np.percentile(wasted_m, 50)) if wasted_m.size else 0.0,
        "wasted_mem_mb_p75": float(np.percentile(wasted_m, 75)) if wasted_m.size else 0.0,
        "wasted_mem_mb_p95": float(np.percentile(wasted_m, 95)) if wasted_m.size else 0.0,
        "cpu_util_p50": float(np.percentile(util_v, 50)) if util_v.size else 0.0,
        "mem_util_p50": float(np.percentile(util_m, 50)) if util_m.size else 0.0,
        "cold_start_pct": 100.0 * len(colds) / len(results),
        "cold_viol_pct": (
            100.0 * len([r for r in viol if r.cold_start]) / max(len(viol), 1)
        ),
        "oom_pct": 100.0 * len([r for r in results if r.oom_killed]) / len(results),
        "timeout_pct": 100.0 * len([r for r in results if r.timed_out]) / len(results),
        "shed_pct": 100.0 * len([r for r in results if r.shed]) / len(results),
    }
