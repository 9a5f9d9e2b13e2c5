"""Cluster model: workers, containers, capacity tracking.

Mirrors the paper's testbed (§7.1): 16 invoker workers x 90 vCPUs x
125 GB, plus the decoupled-resource bookkeeping Shabari's scheduler
needs — per-worker aggregate vCPU AND memory of active invocations
(OpenWhisk tracks only memory, which is what oversubscribes vCPUs
under static-large, Figure 8a).

Containers are (function, vcpus, mem) slots. Idle warm containers hold
no load (§5 "while idle, containers do not consume vCPU or memory") —
worker capacity is consumed by RUNNING invocations plus WARMING
reservations: when the scheduler places an invocation that needs a cold
container, the worker reserves its vCPUs/memory immediately
(:meth:`Worker.reserve`), so ``fits`` and the cluster-level load
aggregates see committed-but-still-warming capacity instead of letting
the router stack cold starts onto a free-looking worker. A reservation
either converts to a running acquisition when the cold start completes
(:meth:`Worker.commit_reservation`) or is released on timeout/cancel
(:meth:`Worker.cancel_reservation`).

Read-side signals for the front door, all incremental (no O(running
invocations) rescans per route):

* ``Worker.idle_warm`` / ``Cluster.has_idle_warm`` — warm containers
  usable NOW (``warm_at <= now``), via the per-function index;
* ``Worker.warming_soon`` / ``Cluster.warming_soon`` — uncommitted
  containers still warming whose ``warm_at`` falls within a horizon
  (background exact-size launches, §5 case 2). Invisible to the warm
  lookups above, these are placement targets for the router's
  estimate-routing mode: an invocation can bind to one and start the
  moment it turns warm;
* per-worker ``active_demand_vcpus`` / ``active_net_gbps`` aggregates —
  the §5 contention inputs, maintained by :meth:`Worker.add_active`/
  :meth:`Worker.remove_active`, so the router can score a candidate
  worker's expected co-runner slowdown in O(1).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fleet import MachineType

_container_ids = itertools.count()


class WorkerArrays:
    """Struct-of-arrays backing store for per-worker mutable state.
    Each :class:`Worker` is a view into one slot of its cluster's
    shared arrays: scalar reads/writes go through the worker facade
    exactly as before, while bulk readers (the router's fleet-wide SLO
    scoring, summaries, tests) can consume a whole cluster's state as
    vectors without touching Python objects.

    Storage is split by access pattern: the contention aggregates and
    machine constants are NumPy arrays because the router's SLO
    scoring consumes them as whole vectors, while the capacity
    counters (used/reserved vcpus + memory) are plain Python lists —
    every reader of those is scalar and per-worker (``fits``, the
    scheduler's per-candidate headroom checks, the worker facade), and
    a list index returns a cheap native int where a NumPy scalar read
    costs ~10x.

    The machine-constant arrays (cores, NIC, exec factor) duplicate
    each worker's :class:`MachineType` values — they are filled once at
    cluster construction from those same objects, never written again.
    """

    __slots__ = (
        "used_vcpus", "used_mem_mb", "reserved_vcpus", "reserved_mem_mb",
        "active_demand_vcpus", "active_net_gbps",
        "physical_cores", "nic_gbps", "exec_factor",
    )

    def __init__(self, n: int):
        self.used_vcpus = [0] * n
        self.used_mem_mb = [0] * n
        self.reserved_vcpus = [0] * n
        self.reserved_mem_mb = [0] * n
        self.active_demand_vcpus = np.zeros(n, dtype=np.float64)
        self.active_net_gbps = np.zeros(n, dtype=np.float64)
        self.physical_cores = np.ones(n, dtype=np.float64)
        self.nic_gbps = np.ones(n, dtype=np.float64)
        self.exec_factor = np.ones(n, dtype=np.float64)

    def fill_machine_constants(self, machines: Sequence[MachineType]) -> None:
        for i, m in enumerate(machines):
            self.physical_cores[i] = m.physical_cores
            self.nic_gbps[i] = m.nic_gbps
            self.exec_factor[i] = m.exec_factor


@dataclasses.dataclass(slots=True)
class Container:
    cid: int
    function: str
    vcpus: int
    mem_mb: int
    worker: "Worker"
    busy: bool = False
    created_at: float = 0.0
    last_used: float = 0.0
    warm_at: float = 0.0  # when the cold start finishes
    # True while the container is warming WITH an invocation committed
    # to it and its (vcpus, mem) held as a reservation on the worker
    reserved: bool = False

    def size_key(self) -> Tuple[int, int]:
        return (self.vcpus, self.mem_mb)


@dataclasses.dataclass
class Worker:
    wid: int
    total_vcpus: int = 90
    total_mem_mb: int = 125 * 1024
    # oversubscription limit (userCPU hyperparameter, §6/§7.5)
    vcpu_limit: int = 90
    # the hardware behind this worker — the single source of the §5
    # model constants (physical cores, NIC Gbps, cold-start curve,
    # exec-speed factor) read by BOTH the simulator's charging and the
    # router's forecasting, so the two cannot drift apart
    machine: MachineType = dataclasses.field(
        default_factory=MachineType, repr=False)
    # owning-cluster backref so acquire/release can maintain the
    # cluster-level load aggregates (None for standalone Workers)
    cluster: Optional["Cluster"] = dataclasses.field(default=None, repr=False)
    # struct-of-arrays backing store (WorkerArrays) + this worker's slot
    # in it. Cluster-built workers share their cluster's arrays so bulk
    # readers can vectorize over every worker at once; a standalone
    # Worker gets a private single-slot store in __post_init__. The
    # scalar attributes below (used_vcpus, reserved_*, active_*) are
    # properties over these slots — same reads/writes as the old plain
    # fields, one storage location.
    soa: Optional[WorkerArrays] = dataclasses.field(default=None, repr=False)
    sidx: int = 0
    containers: Dict[int, Container] = dataclasses.field(default_factory=dict)
    # per-function view of ``containers`` so warm lookups touch only the
    # function's own containers instead of scanning every container on
    # the worker (insertion order matches ``containers``, so results are
    # identical to the full scan)
    by_function: Dict[str, Dict[int, Container]] = dataclasses.field(
        default_factory=dict
    )
    # per-node image/layer store (repro_torch.core.image_cache.NodeImageCache);
    # attached by the simulator when SimConfig(image_cache=...) is set,
    # None in the flat-constant cold-start world
    image_cache: Optional[object] = dataclasses.field(
        default=None, repr=False)

    def __post_init__(self) -> None:
        if self.soa is None:
            self.soa = WorkerArrays(1)
            self.sidx = 0
            self.soa.fill_machine_constants([self.machine])

    # ------------------------------------- SoA-backed scalar views
    # used_* totals COUNT warming reservations (so ``fits`` and the
    # cluster aggregates need no special cases); reserved_* track how
    # much of the total is reservations, for observability and tests.
    # active_* are the incremental aggregates over RUNNING invocations
    # (parallel demand and object-store NIC draw) so contention lookups
    # are O(1) instead of a scan over every running invocation.
    @property
    def used_vcpus(self) -> int:
        return int(self.soa.used_vcpus[self.sidx])

    @used_vcpus.setter
    def used_vcpus(self, v: int) -> None:
        self.soa.used_vcpus[self.sidx] = v

    @property
    def used_mem_mb(self) -> int:
        return int(self.soa.used_mem_mb[self.sidx])

    @used_mem_mb.setter
    def used_mem_mb(self, v: int) -> None:
        self.soa.used_mem_mb[self.sidx] = v

    @property
    def reserved_vcpus(self) -> int:
        return int(self.soa.reserved_vcpus[self.sidx])

    @reserved_vcpus.setter
    def reserved_vcpus(self, v: int) -> None:
        self.soa.reserved_vcpus[self.sidx] = v

    @property
    def reserved_mem_mb(self) -> int:
        return int(self.soa.reserved_mem_mb[self.sidx])

    @reserved_mem_mb.setter
    def reserved_mem_mb(self, v: int) -> None:
        self.soa.reserved_mem_mb[self.sidx] = v

    @property
    def active_demand_vcpus(self) -> float:
        return float(self.soa.active_demand_vcpus[self.sidx])

    @active_demand_vcpus.setter
    def active_demand_vcpus(self, v: float) -> None:
        self.soa.active_demand_vcpus[self.sidx] = v

    @property
    def active_net_gbps(self) -> float:
        return float(self.soa.active_net_gbps[self.sidx])

    @active_net_gbps.setter
    def active_net_gbps(self, v: float) -> None:
        self.soa.active_net_gbps[self.sidx] = v

    def fits(self, vcpus: int, mem_mb: int) -> bool:
        a, i = self.soa, self.sidx
        return (
            a.used_vcpus[i] + vcpus <= self.vcpu_limit
            and a.used_mem_mb[i] + mem_mb <= self.total_mem_mb
        )

    def acquire(self, vcpus: int, mem_mb: int) -> None:
        a, i = self.soa, self.sidx
        a.used_vcpus[i] += vcpus
        a.used_mem_mb[i] += mem_mb
        if self.cluster is not None:
            self.cluster.used_vcpus += vcpus
            self.cluster.used_mem_mb += mem_mb

    def release(self, vcpus: int, mem_mb: int) -> None:
        a, i = self.soa, self.sidx
        a.used_vcpus[i] -= vcpus
        a.used_mem_mb[i] -= mem_mb
        assert a.used_vcpus[i] >= 0 and a.used_mem_mb[i] >= 0
        if self.cluster is not None:
            self.cluster.used_vcpus -= vcpus
            self.cluster.used_mem_mb -= mem_mb

    # -------------------------------------------- warming reservations
    def reserve(self, vcpus: int, mem_mb: int) -> None:
        """Acquire-on-placement: hold capacity for a cold start the
        moment it is placed, before the container finishes warming."""
        a, i = self.soa, self.sidx
        a.reserved_vcpus[i] += vcpus
        a.reserved_mem_mb[i] += mem_mb
        if self.cluster is not None:
            self.cluster.reserved_vcpus += vcpus
            self.cluster.reserved_mem_mb += mem_mb
        self.acquire(vcpus, mem_mb)

    def commit_reservation(self, vcpus: int, mem_mb: int) -> None:
        """Cold start completed: the reservation becomes a running
        acquisition. used_* already count it, so only the reserved
        slice shrinks."""
        a, i = self.soa, self.sidx
        a.reserved_vcpus[i] -= vcpus
        a.reserved_mem_mb[i] -= mem_mb
        assert a.reserved_vcpus[i] >= 0 and a.reserved_mem_mb[i] >= 0
        if self.cluster is not None:
            self.cluster.reserved_vcpus -= vcpus
            self.cluster.reserved_mem_mb -= mem_mb

    def cancel_reservation(self, vcpus: int, mem_mb: int) -> None:
        """The committed invocation will never run (queue timeout /
        cancel): give the capacity back."""
        self.commit_reservation(vcpus, mem_mb)
        self.release(vcpus, mem_mb)

    def add_active(self, demand_vcpus: float, net_gbps: float) -> None:
        a, i = self.soa, self.sidx
        a.active_demand_vcpus[i] += demand_vcpus
        a.active_net_gbps[i] += net_gbps

    def remove_active(self, demand_vcpus: float, net_gbps: float) -> None:
        a, i = self.soa, self.sidx
        a.active_demand_vcpus[i] -= demand_vcpus
        a.active_net_gbps[i] -= net_gbps
        assert a.active_demand_vcpus[i] > -1e-6 and a.active_net_gbps[i] > -1e-6
        # clamp float drift from repeated +=/-= so long runs stay exact
        if a.active_demand_vcpus[i] < 1e-9:
            a.active_demand_vcpus[i] = 0.0
        if a.active_net_gbps[i] < 1e-9:
            a.active_net_gbps[i] = 0.0

    def idle_warm(self, function: str, now: float) -> List[Container]:
        byf = self.by_function.get(function)
        if not byf:
            return []
        return [c for c in byf.values() if not c.busy and c.warm_at <= now]

    def warming_soon(self, function: str, now: float, horizon_s: float,
                     vcpus: int, mem_mb: int) -> Optional[Container]:
        """The soonest-warm UNCOMMITTED container for ``function`` that
        is at least (vcpus, mem_mb) big, still warming with ``warm_at``
        within ``horizon_s`` of ``now``, and whose reservation this
        worker can still take (``fits`` is checked per container, not
        after selection — a too-big soonest candidate must not hide a
        later one that fits).

        Only background-launched containers qualify: a cold start placed
        for a specific invocation is ``busy`` (and ``reserved``) for its
        whole warm-up, so it can never be handed to a second invocation.
        Uses the per-function index — cost is O(this function's
        containers on the worker), not O(all containers)."""
        byf = self.by_function.get(function)
        if not byf:
            return None
        best: Optional[Container] = None
        for c in byf.values():
            if c.busy or c.warm_at <= now or c.warm_at > now + horizon_s:
                continue
            if c.vcpus < vcpus or c.mem_mb < mem_mb:
                continue
            if not self.fits(c.vcpus, c.mem_mb):
                continue
            if best is None or c.warm_at < best.warm_at:
                best = c
        return best


class Cluster:
    def __init__(
        self,
        n_workers: int = 16,
        vcpus_per_worker: int = 90,
        mem_mb_per_worker: int = 125 * 1024,
        vcpu_limit: Optional[int] = None,
        legacy_scans: bool = False,
        machines: Optional[Sequence[MachineType]] = None,
    ):
        # legacy_scans restores the pre-refactor O(containers) warm
        # lookup (see Simulator's SimConfig.legacy_scans) for A/B
        # benchmarking; results are identical either way.
        self.legacy_scans = legacy_scans
        # cluster-level load aggregates, maintained by Worker.acquire/
        # release — the router's O(1) spill-target metric. Reservations
        # (committed-but-warming cold starts) are included in used_*;
        # reserved_* track that slice separately.
        self.used_vcpus = 0
        self.used_mem_mb = 0
        self.reserved_vcpus = 0
        self.reserved_mem_mb = 0
        if machines is None:
            # homogeneous legacy path: one machine type mirroring the
            # worker-shape args (vcpu_limit only overrides the worker
            # cap, not the machine's advertised vcpus)
            uniform = MachineType(
                vcpus=vcpus_per_worker,
                mem_mb=mem_mb_per_worker,
                vcpu_limit=vcpu_limit,
            )
            machines = [uniform] * n_workers
        # one struct-of-arrays store for the whole cluster: every
        # Worker below is a single-slot view into it, and bulk readers
        # (router SLO scoring, tests) vectorize over all workers at once
        self.arrays = WorkerArrays(len(machines))
        self.arrays.fill_machine_constants(machines)
        self.workers = [
            Worker(
                wid=i,
                total_vcpus=m.vcpus,
                total_mem_mb=m.mem_mb,
                vcpu_limit=m.limit,
                machine=m,
                cluster=self,
                soa=self.arrays,
                sidx=i,
            )
            for i, m in enumerate(machines)
        ]
        # cluster-level mirror of each worker's per-function container
        # index: warm lookups for a function touch only ITS containers
        # cluster-wide instead of probing all workers (most hold none).
        # Iteration order is container-creation order; selection-order
        # parity with the per-worker scans is restored by explicit
        # (wid, cid) tie-break keys at the call sites (scheduler,
        # warming_soon below).
        self.by_function: Dict[str, Dict[int, Container]] = {}
        # per-function dict of the IDLE (busy == False) subset of
        # ``by_function``: warm lookups and warming-soon scans touch
        # only containers that can actually be candidates, instead of
        # every container of the function. Maintained eagerly by
        # mark_busy/mark_idle at each busy flip (two O(1) dict ops per
        # invocation lifecycle); iteration order is irrelevant because
        # every reader selects by an explicit total (.., wid, cid) key.
        self.idle_by_function: Dict[str, Dict[int, Container]] = {}

    def mark_busy(self, c: Container) -> None:
        """Flip a container busy and drop it from the idle index."""
        c.busy = True
        byf = self.idle_by_function.get(c.function)
        if byf is not None:
            byf.pop(c.cid, None)

    def mark_idle(self, c: Container) -> None:
        """Flip a container idle (finish, cancelled cold start, idle
        creation) and register it in the idle index."""
        c.busy = False
        self.idle_by_function.setdefault(c.function, {})[c.cid] = c

    def new_container(
        self, worker: Worker, function: str, vcpus: int, mem_mb: int,
        now: float, warm_at: float,
    ) -> Container:
        c = Container(
            cid=next(_container_ids),
            function=function,
            vcpus=vcpus,
            mem_mb=mem_mb,
            worker=worker,
            created_at=now,
            last_used=now,
            warm_at=warm_at,
        )
        worker.containers[c.cid] = c
        worker.by_function.setdefault(function, {})[c.cid] = c
        self.by_function.setdefault(function, {})[c.cid] = c
        # containers are created idle; cold-start placement marks the
        # new container busy immediately after, removing it again
        self.idle_by_function.setdefault(function, {})[c.cid] = c
        return c

    def remove_container(self, c: Container) -> None:
        ic = c.worker.image_cache
        if ic is not None:
            # reaping the container drops its reference to the image's
            # layers; they stay resident but become LRU-evictable
            ic.release(c.function)
        c.worker.containers.pop(c.cid, None)
        byf = c.worker.by_function.get(c.function)
        if byf is not None:
            byf.pop(c.cid, None)
        cbf = self.by_function.get(c.function)
        if cbf is not None:
            cbf.pop(c.cid, None)
        ibf = self.idle_by_function.get(c.function)
        if ibf is not None:
            ibf.pop(c.cid, None)

    def has_idle_warm(self, function: str, now: float) -> bool:
        """Emptiness probe — the router's warm-spill pre-check. The
        cluster-level index holds exactly the union of the per-worker
        indexes, so the predicate matches Worker.idle_warm; legacy_scans
        keeps the per-worker probe for A/B."""
        if self.legacy_scans:
            return any(w.idle_warm(function, now) for w in self.workers)
        byf = self.idle_by_function.get(function)
        if not byf:
            return False
        return any(
            not c.busy and c.warm_at <= now for c in byf.values()
        )

    def warming_soon(self, function: str, now: float, horizon_s: float,
                     vcpus: int, mem_mb: int) -> Optional[Container]:
        """Cluster-wide soonest-warm uncommitted container within the
        horizon whose worker can still take its reservation — the
        estimate router's warming-soon placement candidate. The
        per-worker scan (kept under ``legacy_scans``) picks per-worker
        minima by (warm_at, insertion order) and then keeps the earliest
        worker on ties — i.e. the global min by (warm_at, wid, cid); the
        indexed path selects by that exact key."""
        if self.legacy_scans:
            best: Optional[Container] = None
            for w in self.workers:
                c = w.warming_soon(function, now, horizon_s, vcpus, mem_mb)
                if c is None:
                    continue
                if best is None or c.warm_at < best.warm_at:
                    best = c
            return best
        byf = self.idle_by_function.get(function)
        if not byf:
            return None
        best = None
        best_key = None
        deadline = now + horizon_s
        for c in byf.values():
            if c.busy or c.warm_at <= now or c.warm_at > deadline:
                continue
            if c.vcpus < vcpus or c.mem_mb < mem_mb:
                continue
            if not c.worker.fits(c.vcpus, c.mem_mb):
                continue
            key = (c.warm_at, c.worker.wid, c.cid)
            if best_key is None or key < best_key:
                best, best_key = c, key
        return best

    def idle_warm(self, function: str, now: float) -> List[Container]:
        out: List[Container] = []
        if self.legacy_scans:
            for w in self.workers:
                out.extend(
                    c for c in w.containers.values()
                    if c.function == function and not c.busy
                    and c.warm_at <= now
                )
            return out
        for w in self.workers:
            out.extend(w.idle_warm(function, now))
        return out

    def total_used(self) -> Tuple[int, int]:
        return (self.used_vcpus, self.used_mem_mb)
