"""Front-door router: the multi-cluster tier above §5 scheduling.

The paper's testbed is a single 16-worker cluster; a production FaaS
front door balances MANY clusters, where container-pool locality and
spill-over dominate behavior under flash crowds (Fifer, arXiv
2008.12819) and multi-cluster routing is the open decision layer above
per-invocation right-sizing (arXiv 2510.02404). The router applies the
same cold-start-aware philosophy as Shabari's scheduler, one level up:

Four routing modes (``SimConfig.routing`` selects):

* ``hashing`` — each function is hashed to a "home" cluster and always
  routed there (warm-pool locality, no load awareness);
* ``spill-over`` (default) — route to the home cluster while it can
  serve the invocation; when the home cluster has no warm container,
  prefer a WARM container on a remote cluster over a local cold start,
  and when the home cluster is saturated, spill to the least-loaded
  remote cluster with capacity. Spill decisions rank candidates by raw
  committed-LOAD fraction;
* ``estimate`` — score EVERY candidate cluster by estimated completion
  time (ECT) and route to the minimum (ties prefer home, then lower
  index). The ECT combines, per candidate: residual wait for a warm or
  WARMING-SOON container (an uncommitted background launch whose
  ``warm_at`` falls within ``estimate_horizon_s`` — a placement target
  no other mode can see), expected cold-start latency for the predicted
  container size, scheduling overhead, and the §5 contention slowdown
  from the candidate worker's ``active_demand_vcpus`` /
  ``active_net_gbps`` aggregates applied to a per-function execution
  estimate calibrated online from observed exec times
  (:meth:`Router.observe_exec`). Spills happen only when the estimate
  says a remote placement finishes sooner — a contended home warm pool
  loses to an idle remote cold start once the slowdown exceeds the
  cold-start price. Unlike the other modes this one does NOT degenerate
  at ``n_clusters=1``: warming-soon binding still short-circuits cold
  starts inside a single cluster;
* ``random`` — seeded uniform cluster choice (the load-oblivious
  baseline for benchmarks/router_bench).

``route`` composes per-cluster :class:`ShabariScheduler` decisions and
is itself side-effect-free: like ``schedule``, it only inspects state,
so the runtime remains the sole owner of load mutation. The one
exception is estimate mode's warming-soon choice, which returns a
``Decision.pending`` container for the RUNTIME to commit (mark busy +
reserve) — the router still mutates nothing itself. ``RouteDecision.
est_s`` carries the winning estimate for observability (None outside
estimate mode).

The ``_load`` signal is truthful about in-flight cold starts: the
runtime reserves capacity at PLACEMENT (``Worker.reserve``), so a
cold-started container counts against its cluster's load for the whole
warm-up window and arrivals inside that ~0.5-1 s window no longer herd
onto the same least-loaded remote (the old acquire-on-start behavior is
kept behind ``SimConfig(legacy_acquire=True)`` for A/B).

On top of that signal the router applies front-door ADMISSION CONTROL:

* ``admission="shed"`` / ``"queue"`` — the load-headroom test: when
  every cluster's committed load (running + reserved) exceeds the
  ``admission_headroom`` occupancy fraction, new arrivals are shed at
  the front door or held in the front-door queue without probing any
  scheduler;
* ``admission="slo"`` — the SLO-native test: instead of fleet-wide
  load, compute the MINIMUM completion-time estimate across clusters
  (the same ``_estimate`` scoring estimate routing uses, so it works
  under any routing policy) and shed exactly the invocations whose
  best estimate already exceeds their remaining SLO budget — work that
  cannot be served in time no matter where it lands, which the
  load-headroom test cannot distinguish from servable work. Functions
  with no calibration yet are always admitted (never shed on the bare
  prior);
* the default ``admission="none"`` admits everything and lets
  per-cluster queueing absorb overload, as before.

The exec estimate behind both the scoring and the SLO test is
PER-INPUT when the caller supplies the invocation's feature vector
(``route(..., features=..., input_mb=...)``): observed completions
train a per-function online regressor (:mod:`repro_torch.core.ect`) over the
Featurizer output + input size, with the per-function EWMA as the cold
prior. ``estimate_features=False`` restores the input-blind EWMA-only
estimator for A/B.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import random

import numpy as np
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import Allocation
from repro_torch.core.cluster import Cluster, Worker
from repro_torch.core.fleet import COLD_JITTER_MEAN, Topology
from repro_torch.core.ect import (
    ECT_BLIND_SHED_BAND,
    ECT_ERR_WIDEN,
    ECT_SHED_OBS,
    ECT_SLO_MARGIN,
    ECT_WARMUP_OBS,
    ECTRegressor,
)
from repro_torch.core.scheduler import Decision, ShabariScheduler

ROUTING_POLICIES = ("hashing", "spill-over", "estimate", "random")
ADMISSION_POLICIES = ("none", "shed", "queue", "slo")

# estimate-mode calibration: EWMA smoothing for observed per-function
# exec times, and the prior used before the first observation (seconds)
EXEC_EWMA_ALPHA = 0.3
DEFAULT_EXEC_ESTIMATE_S = 1.0


@dataclasses.dataclass(slots=True)
class RouteDecision:
    cluster_idx: int
    decision: Decision
    spilled: bool = False  # placed off the function's home cluster
    shed: bool = False  # rejected by fleet-wide admission control
    # estimate mode: the winning candidate's estimated completion time
    # (seconds from now until the invocation would finish), None for
    # every other routing policy and for queued/shed outcomes
    est_s: Optional[float] = None


class Router:
    def __init__(
        self,
        clusters: Sequence[Cluster],
        schedulers: Sequence[ShabariScheduler],
        *,
        routing: str = "spill-over",
        seed: int = 0,
        admission: str = "none",
        admission_headroom: float = 0.95,
        estimate_horizon_s: float = 1.5,
        sched_overhead_s: float = 0.001,
        topology: Optional[Topology] = None,
        price_transfer: bool = True,
        pool_key: Optional[Callable[[str], str]] = None,
        network_fed: Optional[Callable[[str], bool]] = None,
        estimate_features: bool = True,
        image_resolver=None,  # function -> ImageSpec; prices each cold
        # candidate's residual registry pull (None = flat cold curve)
    ):
        assert routing in ROUTING_POLICIES, routing
        assert admission in ADMISSION_POLICIES, admission
        assert 0.0 < admission_headroom <= 1.0 or admission == "none"
        assert len(clusters) == len(schedulers) > 0
        # route() composes schedulers[i] decisions with clusters[i]
        # load/warm-pool inspection; a mispaired zip would silently
        # route on the wrong cluster's state
        assert all(
            s.cluster is c for c, s in zip(clusters, schedulers)
        ), "schedulers must be paired 1:1 with clusters, in order"
        self.clusters: List[Cluster] = list(clusters)
        self.schedulers: List[ShabariScheduler] = list(schedulers)
        self.routing = routing
        self.admission = admission
        self.admission_headroom = admission_headroom
        # Estimate-mode hardware model: cold-start curve, §5 contention
        # denominators, and exec-speed factor all come from each
        # candidate Worker's OWN MachineType (repro_torch.core.fleet) — the
        # exact hardware the runtime will charge, one source of truth
        # instead of parallel constructor constants that can drift.
        # The topology prices the input-payload transfer a remote
        # placement pays; price_transfer=False scores spills as free
        # (the pre-fleet assumption, kept for A/B — fleet_bench).
        assert estimate_horizon_s >= 0.0
        self.estimate_horizon_s = estimate_horizon_s
        self.sched_overhead_s = sched_overhead_s
        self.topology = topology
        self.price_transfer = price_transfer
        # transfer pricing short-circuits on free topologies (the
        # default), so uniform fleets never hash home clusters per score
        self._price_transfer_active = (
            price_transfer and topology is not None
            and not topology.is_free()
        )
        self.network_fed = network_fed
        self.image_resolver = image_resolver
        # calibration pool key: estimator state (EWMAs, observation
        # counts, the per-input regressor) is keyed by pool_key(fn) —
        # the simulator passes base_function, so clone aliases (fn::k)
        # share exec evidence instead of each relearning from scratch.
        # Identity when None.
        self._pool: Callable[[str], str] = pool_key or (lambda fn: fn)
        # per-pool EWMAs of observed UNCONTENDED exec seconds and
        # object-store NIC draw — the calibration state behind
        # _exec_estimate/_slowdown (fed by observe_exec). The exec EWMA
        # doubles as the cold prior (and clamp anchor) for the
        # per-input regressor below.
        self._exec_ewma: Dict[str, float] = {}
        self._net_ewma: Dict[str, float] = {}
        # per-function completion counts behind the EWMAs — admission
        # ("slo") refuses to shed on estimates younger than ECT_SHED_OBS
        self._exec_obs: Dict[str, int] = {}
        # per-input exec estimation: a per-function online regressor
        # over the invocation's feature vector (repro_torch.core.ect);
        # estimate_features=False keeps the EWMA-only estimator for A/B
        self.estimate_features = estimate_features
        self._ect = ECTRegressor()
        self._rng = random.Random(seed)
        # per-cluster vCPU capacity is fixed for the cluster's lifetime
        self._capacity = [
            max(sum(w.vcpu_limit for w in cl.workers), 1)
            for cl in self.clusters
        ]
        # home_cluster is a pure function of the name; memoize the md5
        self._home_cache: Dict[str, int] = {}
        # observability counters (benchmarks/router_bench + admission_bench)
        self.routed_home = 0
        self.spills_warm = 0  # remote warm container beat a local cold start
        self.spills_cold = 0  # home saturated; cold-started remotely
        # estimate mode: invocations bound to a still-warming container
        # (counted IN ADDITION to routed_home/spills_warm)
        self.binds_warming = 0
        self.admission_shed = 0  # arrivals rejected at the front door
        # the admission="slo" slice of admission_shed: invocations whose
        # best completion-time estimate exceeded their SLO budget
        self.admission_slo_shed = 0
        # slo-mode invocations HELD instead of shed: the contended
        # estimate said "doomed" but a warm/warming-soon container's
        # optimistic (contention-free) ECT still fits the remaining
        # budget, so the arrival waits at the front door for the
        # contention to drain rather than being irreversibly dropped
        self.admission_slo_held = 0
        # queue-mode rejections count EVENTS, not arrivals: a held
        # arrival re-enters route() on every retry and increments this
        # each time (the router cannot tell a retry from a new arrival)
        self.admission_queue_events = 0

    # ------------------------------------------------------------ utils
    def home_cluster(self, function: str) -> int:
        # salted so the cluster choice is independent of the scheduler's
        # home-WORKER hash of the same name: with a shared unsalted hash
        # and gcd(n_clusters, n_workers) > 1, every function homed on
        # cluster k would also home on worker k, collapsing the
        # within-cluster cold-placement spread into packing
        h = self._home_cache.get(function)
        if h is None:
            h = int(
                hashlib.md5(b"cluster:" + function.encode()).hexdigest(), 16
            ) % len(self.clusters)
            self._home_cache[function] = h
        return h

    def _load(self, ci: int) -> float:
        """Committed vCPU occupancy fraction — the spill-over target and
        admission-control metric. Includes warming reservations (the
        cluster's used_vcpus count them), so in-flight cold starts are
        visible the moment they are placed. O(1): the cluster maintains
        its load aggregate on acquire/release/reserve, so retry storms
        don't rescan workers per route."""
        return self.clusters[ci].used_vcpus / self._capacity[ci]

    def _admission_reject(self) -> bool:
        """Fleet-wide overload test: every cluster's committed load
        (running + warming reservations) is past the headroom fraction.
        One under-headroom cluster is enough to admit — per-cluster
        saturation is the schedulers' business, not the front door's."""
        if self.admission == "none":
            return False
        # plain loop, not all(genexpr): this runs once per retry of
        # every front-door-held arrival, and a saturated fleet retries
        # in storms — generator frames would dominate the retry cost
        hr = self.admission_headroom
        for cl, cap in zip(self.clusters, self._capacity):
            if cl.used_vcpus / cap < hr:
                return False
        return True

    def try_requeue(self) -> bool:
        """Front-door fast path for RETRIES held by queue-mode
        admission: when the fleet is still past the headroom,
        ``route()`` would rebuild the identical queued decision without
        probing any scheduler — so report "still held" directly,
        replicating route()'s only side effect in that branch (the
        ``admission_queue_events`` counter). Returns False in every
        other admission mode (including "shed", whose retries must
        reach route() to be dropped) and whenever the fleet has
        headroom again."""
        if self.admission != "queue":
            return False
        # same test as _admission_reject, inlined: this is the hottest
        # call in a retry storm (once per held arrival per interval)
        hr = self.admission_headroom
        for cl, cap in zip(self.clusters, self._capacity):
            if cl.used_vcpus / cap < hr:
                return False
        self.admission_queue_events += 1
        return True

    # ------------------------------------------------- estimate scoring
    def observe_exec(self, function: str, base_exec_s: float,
                     net_gbps: float = 0.0, *, features=None,
                     input_mb: Optional[float] = None) -> None:
        """Estimator calibration hook: the runtime reports each
        completion's UNCONTENDED execution time (seconds; the §5
        contention factor already divided out, so candidate scoring can
        re-apply each candidate's own slowdown without double counting)
        and its object-store NIC draw (Gbps; 0 for non-network-fed
        functions). Both fold into per-function EWMAs
        (``EXEC_EWMA_ALPHA``); functions with no observation yet use
        ``DEFAULT_EXEC_ESTIMATE_S`` / zero draw. When the caller also
        supplies the invocation's feature vector (+ input MB), the
        observation additionally trains the per-input regressor
        (:mod:`repro_torch.core.ect`) unless ``estimate_features`` is off.
        The feed is deterministic given the event order, so
        estimate-mode runs stay reproducible under a fixed seed.

        The reported time is REFERENCE-machine normalized (the runtime
        divides out its worker's exec-speed factor along with the
        contention slowdown), so one estimator serves every machine
        type — candidate scoring re-applies each candidate's own
        factor. State is keyed by the calibration pool
        (``pool_key``), so clone aliases share one model."""
        if base_exec_s <= 0.0:
            return
        key = self._pool(function)
        prev = self._exec_ewma.get(key)
        self._exec_ewma[key] = (
            base_exec_s if prev is None
            else (1.0 - EXEC_EWMA_ALPHA) * prev + EXEC_EWMA_ALPHA * base_exec_s
        )
        self._exec_obs[key] = self._exec_obs.get(key, 0) + 1
        prev_net = self._net_ewma.get(key)
        self._net_ewma[key] = (
            net_gbps if prev_net is None
            else (1.0 - EXEC_EWMA_ALPHA) * prev_net
            + EXEC_EWMA_ALPHA * net_gbps
        )
        if self.estimate_features and features is not None:
            # train on the residual off the pre-update EWMA (first
            # observation: off itself, a zero residual)
            self._ect.observe(key, features,
                              input_mb if input_mb is not None else 0.0,
                              base_exec_s,
                              prev if prev is not None else base_exec_s)

    def _exec_estimate(self, function: str, features=None,
                       input_mb: Optional[float] = None) -> float:
        """Per-function exec forecast: the per-input regressor when it
        is trained and the caller supplied this invocation's features,
        else the EWMA (also the regressor's cold prior and clamp
        anchor); ``DEFAULT_EXEC_ESTIMATE_S`` before any observation.
        Reference-machine seconds — callers scale by the candidate
        worker's ``exec_factor``."""
        key = self._pool(function)
        prior = self._exec_ewma.get(key, DEFAULT_EXEC_ESTIMATE_S)
        if self.estimate_features and features is not None:
            est = self._ect.predict(
                key, features,
                input_mb if input_mb is not None else 0.0, prior)
            if est is not None:
                return est
        return prior

    def _transfer_s(self, function: str, ci: int,
                    input_mb: Optional[float]) -> float:
        """Input-payload transfer price for serving ``function`` on
        cluster ``ci``: the payload lives in the home cluster's object
        store, so remote placements pay the link (exactly what the
        runtime charges). 0.0 on free topologies or with
        ``price_transfer=False`` (the transfer-BLIND A/B arm)."""
        if not self._price_transfer_active:
            return 0.0
        return self.topology.transfer_s(
            self.home_cluster(function), ci,
            input_mb if input_mb is not None else 0.0)

    def _slowdown(self, w: Worker, function: str, vcpus: float) -> float:
        """Forecast §5 contention on ``w`` if this invocation lands
        there: CPU slowdown from active parallel demand plus our own
        footprint (``vcpus`` — the size the invocation will actually
        RUN at, i.e. the bound container's size for warm/warming binds,
        which case-(2) can make larger than the request; an upper bound
        on the function's true demand), NIC slowdown from current
        object-store draw plus our own calibrated draw (the net EWMA;
        the runtime charges the arriving invocation's draw too, so the
        forecast must or it would systematically understate busy-NIC
        placements) for network-fed functions. O(1) — reads the
        worker's incremental aggregates and its own MachineType's §5
        denominators (cores, NIC) — the same values the runtime
        divides by."""
        cpu = max(
            1.0,
            (w.active_demand_vcpus + float(vcpus)) / w.machine.physical_cores,
        )
        net = 1.0
        if self.network_fed is not None and self.network_fed(function):
            own = self._net_ewma.get(self._pool(function), 0.0)
            net = max(1.0, (w.active_net_gbps + own) / w.machine.nic_gbps)
        return max(cpu, net)

    def _estimate(self, ci: int, function: str, alloc: Allocation,
                  now: float, features=None,
                  input_mb: Optional[float] = None
                  ) -> Tuple[float, str, object]:
        """Estimated completion time if cluster ``ci`` served this
        invocation, as ``(est_s, kind, payload)`` with kind one of
        ``"warm"`` / ``"warming"`` / ``"cold"`` / ``"queue"``.

        The kinds mirror what the cluster's scheduler would actually do
        (warm containers win before cold starts), so the estimate and
        the eventual binding agree; ``"queue"`` (no capacity) is
        returned with an infinite estimate — the route pass never binds
        to a cluster that cannot place."""
        cl = self.clusters[ci]
        exec_est = self._exec_estimate(function, features, input_mb)
        # transfer price for landing on this cluster (0.0 for home,
        # free topologies, or the transfer-blind A/B arm). Mirrors the
        # runtime's charging: warm placements pay it serially, cold and
        # warming placements overlap it with the warm-up wait.
        xfer = self._transfer_s(function, ci, input_mb)
        # (a) warm container usable now — the EXACT container scheduler
        # cases (1)/(2) would bind, so the contention forecast prices
        # the worker that will actually serve the invocation. The
        # slowdown is priced with the CONTAINER's size, not the
        # request's: the runtime runs the invocation at c.vcpus, which
        # a case-(2) bind can make larger than alloc.vcpus. exec_est is
        # reference-machine seconds; the bind worker's exec-speed
        # factor scales it to local silicon.
        c = self.schedulers[ci].warm_candidate(function, alloc.vcpus,
                                               alloc.mem_mb, now)
        if c is not None:
            slow = self._slowdown(c.worker, function, c.vcpus)
            est = (xfer + self.sched_overhead_s
                   + slow * (exec_est * c.worker.machine.exec_factor))
            return (est, "warm", c)
        # (b)/(c) no warm container: compare binding to a warming-soon
        # container (pay the residual warm-up) against this cluster's
        # own cold start, and forecast the cheaper. Unlike the warm
        # case there is no scheduler binding to mirror — the warming
        # bind is a router-invented placement — so a container warming
        # near the horizon edge must not shadow a faster cold start on
        # an idle worker.
        c = cl.warming_soon(function, now, self.estimate_horizon_s,
                            alloc.vcpus, alloc.mem_mb)
        warming_est = None
        if c is not None:
            # like the warm case, a warming bind runs at the container's
            # size (warming_soon only returns >= alloc candidates)
            slow = self._slowdown(c.worker, function, c.vcpus)
            warming_est = (max(c.warm_at - now, xfer)
                           + self.sched_overhead_s
                           + slow * (exec_est
                                     * c.worker.machine.exec_factor))
        w = self.schedulers[ci].cold_candidate(function, alloc.vcpus,
                                               alloc.mem_mb)
        cold_est = None
        if w is not None:
            # cold starts create an exact-size container, at the target
            # machine's own cold-start curve scaled by the EXPECTATION
            # of the simulator's lognormal jitter (COLD_JITTER_MEAN), so
            # the estimator prices the runtime's mean draw rather than
            # its median
            slow = self._slowdown(w, function, alloc.vcpus)
            cold_lat = (w.machine.cold_latency_s(alloc.mem_mb)
                        * COLD_JITTER_MEAN)
            if self.image_resolver is not None and w.image_cache is not None:
                # pull-what's-missing: the registry fetch overlaps the
                # container-create cost, so this candidate's cold price
                # is whichever of the two dominates
                cold_lat = max(cold_lat, w.image_cache.residual_pull_s(
                    self.image_resolver(function)))
            cold_est = (max(cold_lat, xfer)
                        + self.sched_overhead_s
                        + slow * (exec_est * w.machine.exec_factor))
        if warming_est is not None and (cold_est is None
                                        or warming_est <= cold_est):
            # ties prefer the warming bind: its warm-up is already paid
            # for, so no new container (and no new reservation window)
            return (warming_est, "warming", c)
        if cold_est is not None:
            return (cold_est, "cold", w)
        # (d) saturated: nothing can be placed here right now
        return (float("inf"), "queue", None)

    def _route_estimate(self, function: str, alloc: Allocation,
                        now: float, features=None,
                        input_mb: Optional[float] = None,
                        budget_s: Optional[float] = None) -> RouteDecision:
        """Minimum-ECT routing: score every cluster, bind the winner.
        Ties break toward the home cluster (warm-pool locality is free
        tie insurance), then the lower cluster index — fully
        deterministic.

        ``budget_s`` (chain stages only) makes the ranking SLACK-AWARE:
        candidates whose estimate fits the remaining end-to-end budget
        are ranked home-cluster-first — a stage with slack tolerates a
        local cold start instead of spilling to a remote warm container,
        preserving warm pools (and the warm containers themselves) for
        the stages that have no slack to spend. Candidates over budget
        keep the pure min-ECT order, so a critical-path stage (nothing
        fits) degenerates to exactly today's warm-priority behavior.
        ``budget_s=None`` is bit-identical to the pre-chain ranking."""
        n = len(self.clusters)
        home = self.home_cluster(function)
        best = None
        for ci in range(n):
            est, kind, payload = self._estimate(ci, function, alloc, now,
                                                features, input_mb)
            if kind == "queue":
                continue
            if budget_s is not None and est <= budget_s:
                key = (0, ci != home, est, ci)
            else:
                key = (1, est, ci != home, ci)
            if best is None or key < best[0]:
                best = (key, est, ci, kind, payload)
        if best is None:
            # no cluster can place it — same terminal as spill-over's
            # everything-saturated case; the runtime retries
            return RouteDecision(
                home,
                Decision(None, cold_start=False, background_launch=None,
                         queued=True),
            )
        _, est, ci, kind, payload = best
        spilled = ci != home
        if kind == "warming":
            # bind to the still-warming container: the runtime commits
            # it (busy + reservation) and starts the invocation at
            # payload.warm_at — a short wait instead of a cold start
            d = Decision(None, cold_start=False, background_launch=None,
                         pending=payload)
            self.binds_warming += 1
            if spilled:
                self.spills_warm += 1
            else:
                self.routed_home += 1
            return RouteDecision(ci, d, spilled=spilled, est_s=est)
        # the winning candidate was already probed by _estimate on state
        # that cannot have changed since, so build the Decision from it
        # directly instead of re-running schedule()'s warm/cold scans —
        # the constructions below mirror schedule()'s cases (1)-(3)
        if kind == "warm":
            c = payload
            bg = None
            if not (c.vcpus == alloc.vcpus and c.mem_mb == alloc.mem_mb):
                # case 2: proactively launch the exact size in the
                # background, like schedule() would
                sched = self.schedulers[ci]
                if sched.background_launch:
                    w = sched.cold_candidate(function, alloc.vcpus,
                                             alloc.mem_mb)
                    if w is not None:
                        bg = (w, alloc.vcpus, alloc.mem_mb)
            d = Decision(c, cold_start=False, background_launch=bg)
            if spilled:
                self.spills_warm += 1
            else:
                self.routed_home += 1
            return RouteDecision(ci, d, spilled=spilled, est_s=est)
        d = Decision(None, cold_start=True,
                     background_launch=(payload, alloc.vcpus, alloc.mem_mb))
        if spilled:
            self.spills_cold += 1
        else:
            self.routed_home += 1
        return RouteDecision(ci, d, spilled=spilled, est_s=est)

    def _slo_reject(self, function: str, alloc: Allocation, now: float,
                    slo_s: float, features, input_mb) -> bool:
        """SLO-native admission test (``admission="slo"``): shed exactly
        the invocations whose BEST completion-time estimate across the
        fleet already exceeds ``slo_s`` (the invocation's REMAINING SLO
        budget — callers subtract time already spent queueing). A
        non-positive budget is an unconditional shed: the SLO is missed
        no matter what, so running (or retrying) the invocation can
        only waste capacity. Functions with no calibration are always
        admitted — never shed on the bare prior — and an infinite
        estimate (nothing can be placed RIGHT NOW) falls through to
        normal queue/retry, which may still serve the invocation in
        time.

        The min-ECT here is the invocation's IRREDUCIBLE completion
        time: scheduling overhead plus the per-input exec estimate
        under the least-contended worker's §5 slowdown anywhere in the
        fleet. Situational latencies — cold starts, queueing — are
        deliberately NOT charged: a first arrival that must cold-start
        may well blow a tight SLO, but the container it warms is what
        makes every successor servable, so shedding on cold-start
        latency starves the warm pool and cascades (each shed prevents
        the warming that would have admitted the next arrival).
        Violations the situational latency causes are charged to the
        invocation that pays them, exactly as under every other
        admission mode.

        The shed threshold also tracks the ESTIMATE's uncertainty. An
        input-blind estimate (the EWMA, or a just-warmed regressor
        still predicting near its prior) forecasts the MEAN over an
        input distribution whose per-input SLOs track per-input exec
        times, so shedding at the mean would drop every small-input
        invocation of a high-variance function — exactly the servable
        work this mode exists to protect. A shed is also irreversible
        (the work is dropped), so estimates earn shedding rights only
        as their specific failure modes are ruled out, via two bands:

        * a MATURE input-blind estimate (``ECT_SHED_OBS`` completions —
          a few heavy first draws hold the early EWMA an order of
          magnitude above steady state) sheds past
          ``ECT_BLIND_SHED_BAND`` x the budget — beyond the whole
          multiplicative band the input distribution can occupy around
          its mean, the work is doomed whatever the input turns out to
          be;
        * a trained per-input forecast that ACTIVELY flags the input
          as heavier than the prior (prediction above the EWMA — the
          model has learned something this-input-specific, not merely
          echoed the mean) sheds past the much tighter
          ``ECT_SLO_MARGIN`` x band, which is where the heavy-tail
          capacity savings come from. The band widens with the
          regressor's own measured one-step-ahead log error
          (``ECT_ERR_WIDEN``): model accuracy is function-specific, and
          a function the features do not explain must not shed on
          confident-looking mispredictions."""
        if slo_s <= 0.0:
            return True
        key = self._pool(function)
        prior = self._exec_ewma.get(key)
        if prior is None:
            return False
        per_input = (self.estimate_features and features is not None
                     and self._ect.observations(key) >= ECT_WARMUP_OBS)
        exec_est = self._exec_estimate(function, features, input_mb)
        # irreducible ECT PER CLUSTER, then the fleet-wide best: each
        # cluster's cheapest worker (its own §5 slowdown and exec-speed
        # factor) plus that cluster's transfer price. A fleet-min
        # slowdown over all workers would let a far/slow cluster's idle
        # machine mask that no cluster can actually serve in budget.
        # On a uniform free-link fleet this reduces exactly to the old
        # fleet-min expression.
        net_fed = (self.network_fed is not None
                   and self.network_fed(function))
        own_net = self._net_ewma.get(key, 0.0) if net_fed else 0.0
        v = float(alloc.vcpus)

        def _cheapest(cl) -> float:
            a = getattr(cl, "arrays", None)
            if a is None:
                # non-SoA cluster stub (tests): scalar fallback
                return min(
                    self._slowdown(w, function, alloc.vcpus)
                    * (exec_est * w.machine.exec_factor)
                    for w in cl.workers
                )
            # vectorized §5 slowdown over the cluster's worker arrays —
            # elementwise float64 ops match the scalar math bit-for-bit
            cpu = np.maximum(1.0, (a.active_demand_vcpus + v)
                             / a.physical_cores)
            if net_fed:
                cpu = np.maximum(
                    cpu,
                    np.maximum(1.0, (a.active_net_gbps + own_net)
                               / a.nic_gbps),
                )
            return float(np.min(cpu * (exec_est * a.exec_factor)))

        est = min(
            self._transfer_s(function, ci, input_mb)
            + self.sched_overhead_s
            + _cheapest(cl)
            for ci, cl in enumerate(self.clusters)
        )
        if (self._exec_obs.get(key, 0) >= ECT_SHED_OBS
                and est > slo_s * ECT_BLIND_SHED_BAND):
            return True
        margin = ECT_SLO_MARGIN * math.exp(
            ECT_ERR_WIDEN * self._ect.log_error(key))
        return (per_input and exec_est > prior
                and est > slo_s * margin)

    def _warm_hold(self, function: str, alloc: Allocation, now: float,
                   slo_s: float, features=None,
                   input_mb: Optional[float] = None) -> bool:
        """Estimate-aware admission queueing: the contended `_slo_reject`
        estimate said "shed", but shedding is IRREVERSIBLE while holding
        is not — a held arrival re-tests on every retry and the
        non-positive-budget rule still terminates it. So before
        dropping, check whether ANY warm or warming-soon container
        could serve the invocation within budget under an OPTIMISTIC
        (contention-free) estimate: transfer + scheduling overhead +
        the exec forecast at the candidate machine's speed, plus the
        residual warm-up for a warming bind. The contended estimate
        must stay conservative (it gates an irreversible drop); the
        hold test may be optimistic because the §5 contention that
        doomed the contended figure is exactly what draining co-runners
        removes while the arrival waits. No warm capacity anywhere →
        the shed stands."""
        exec_est = self._exec_estimate(function, features, input_mb)
        for ci, sched in enumerate(self.schedulers):
            xfer = self._transfer_s(function, ci, input_mb)
            c = sched.warm_candidate(function, alloc.vcpus, alloc.mem_mb,
                                     now)
            if c is not None:
                est = (xfer + self.sched_overhead_s
                       + exec_est * c.worker.machine.exec_factor)
                if est <= slo_s:
                    return True
            c = self.clusters[ci].warming_soon(
                function, now, self.estimate_horizon_s,
                alloc.vcpus, alloc.mem_mb)
            if c is not None:
                est = (max(c.warm_at - now, xfer) + self.sched_overhead_s
                       + exec_est * c.worker.machine.exec_factor)
                if est <= slo_s:
                    return True
        return False

    # ------------------------------------------------------------ route
    def route(self, function: str, alloc: Allocation, now: float, *,
              features=None, input_mb: Optional[float] = None,
              slo_s: Optional[float] = None,
              budget_s: Optional[float] = None) -> RouteDecision:
        """Place one invocation. ``features``/``input_mb`` are the
        invocation's already-computed feature vector + input size (the
        policy's ``aux`` cache) — optional; without them every estimate
        falls back to the per-function EWMA. ``slo_s`` is the remaining
        SLO budget, read only by ``admission="slo"``. ``budget_s`` is a
        chain stage's remaining end-to-end budget — it makes estimate
        routing slack-aware (see ``_route_estimate``); None everywhere
        else."""
        n = len(self.clusters)
        if self.admission == "slo":
            if slo_s is not None and self._slo_reject(
                    function, alloc, now, slo_s, features, input_mb):
                home = 0 if n == 1 else self.home_cluster(function)
                rejected = Decision(None, cold_start=False,
                                    background_launch=None, queued=True)
                if slo_s > 0.0 and self._warm_hold(
                        function, alloc, now, slo_s, features, input_mb):
                    # hold at the front door instead of shedding: the
                    # runtime retries it like a queued arrival
                    self.admission_slo_held += 1
                    return RouteDecision(home, rejected)
                self.admission_shed += 1
                self.admission_slo_shed += 1
                return RouteDecision(home, rejected, shed=True)
        elif self._admission_reject():
            home = 0 if n == 1 else self.home_cluster(function)
            rejected = Decision(None, cold_start=False, background_launch=None,
                                queued=True)
            if self.admission == "shed":
                self.admission_shed += 1
                return RouteDecision(home, rejected, shed=True)
            self.admission_queue_events += 1  # queue-at-front-door: retry later
            return RouteDecision(home, rejected)
        if self.routing == "estimate":
            # does NOT degenerate at n == 1: warming-soon binding still
            # short-circuits single-cluster cold starts
            return self._route_estimate(function, alloc, now,
                                        features, input_mb, budget_s)
        if n == 1:
            d = self.schedulers[0].schedule(function, alloc, now)
            if not d.queued:
                self.routed_home += 1
            return RouteDecision(0, d)

        if self.routing == "random":
            ci = self._rng.randrange(n)
            d = self.schedulers[ci].schedule(function, alloc, now)
            spilled = ci != self.home_cluster(function)
            if not spilled:
                if not d.queued:
                    self.routed_home += 1
            elif not d.queued:
                if d.container is not None:
                    self.spills_warm += 1
                else:
                    self.spills_cold += 1
            return RouteDecision(ci, d, spilled=spilled)

        home = self.home_cluster(function)
        d = self.schedulers[home].schedule(function, alloc, now)
        if self.routing == "hashing" or d.container is not None:
            # pinned, or a local warm hit (exact or larger) — stay home.
            # Counters record PLACEMENTS only (queued attempts and their
            # retries don't count), matching the spills_* semantics.
            if not d.queued:
                self.routed_home += 1
            return RouteDecision(home, d)

        # home has no usable warm container: it would cold-start (if it
        # has headroom) or queue. Least-loaded-first over the remotes;
        # ties break on cluster index, keeping the walk deterministic.
        home_load = self._load(home)
        remotes = sorted(
            (self._load(ci), ci) for ci in range(n) if ci != home
        )

        # cold-start-aware: a remote WARM container beats a local cold
        # start (container create latency >> cross-cluster routing) —
        # but only on a remote under LESS load than home. Spilling onto
        # an equally- or more-loaded cluster trades the cold start for
        # co-runner contention and smears the function's warm pool
        # across clusters, raising everyone's future cold-start rate.
        # route() mutates nothing, so decisions computed here stay valid
        # for the saturation pass below — no re-scheduling per remote.
        probed: dict = {}
        for load, ci in remotes:
            if load >= home_load:
                break  # sorted ascending: no better remote exists
            if not self.clusters[ci].has_idle_warm(function, now):
                continue
            rd = probed[ci] = self.schedulers[ci].schedule(function, alloc, now)
            if rd.container is not None:
                self.spills_warm += 1
                return RouteDecision(ci, rd, spilled=True)

        if not d.queued:
            # no warm container anywhere; home has capacity — cold-start
            # locally so future invocations find their pool at home
            self.routed_home += 1
            return RouteDecision(home, d)

        # home saturated: spill to the least-loaded remote cluster that
        # can actually take it (its scheduler may still find a warm
        # container the load-guarded pass above skipped)
        for _, ci in remotes:
            rd = probed.get(ci)
            if rd is None:
                rd = self.schedulers[ci].schedule(function, alloc, now)
            if not rd.queued:
                if rd.container is not None:
                    self.spills_warm += 1
                else:
                    self.spills_cold += 1
                return RouteDecision(ci, rd, spilled=True)

        return RouteDecision(home, d)  # saturated everywhere -> queued
