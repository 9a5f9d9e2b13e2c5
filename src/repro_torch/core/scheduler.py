"""Shabari's Scheduler (paper §5).

Given the Resource Allocator's (vcpus, mem) prediction for an
invocation, decide which container/worker runs it:

  1. a warm idle container of the EXACT predicted size;
  2. else the warm idle container LARGER but closest to the prediction —
     and proactively launch an exact-size container in the background,
     off the critical path, for future invocations;
  3. else cold-start an exact-size container.

Cold placement hashes the function to a "home server" (cache locality,
like OpenWhisk) and walks forward from it while workers lack capacity;
if none fits, the invocation queues for retry. A packing alternative
(Hermod-style: fill one server before the next) is included for the
Figure 7b ablation — it loses at high load because co-locating many
network-hungry invocations saturates the server.

Load accounting uses BOTH vCPU and memory per worker (OpenWhisk's
memory-only policy is what oversubscribes vCPUs, §5 reason 3), with the
``userCPU`` oversubscription limit from §6. ``Worker.fits`` counts
committed-but-warming reservations (acquire-on-placement,
``repro_torch.core.cluster``), so the cold-placement walk skips workers whose
capacity is already promised to in-flight cold starts instead of
stacking onto them; warming containers are ``busy`` and therefore never
candidates for the warm-routing cases (1)/(2).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

from repro_torch.core.allocator import Allocation
from repro_torch.core.cluster import Cluster, Container, Worker


@dataclasses.dataclass(slots=True)
class Decision:
    container: Optional[Container]
    cold_start: bool
    # exact-size container to launch in the background (case 2)
    background_launch: Optional[Tuple[Worker, int, int]]
    queued: bool = False  # no capacity anywhere
    # estimate-routing only (repro_torch.core.router): a still-warming
    # uncommitted container the invocation binds to — it starts the
    # moment ``pending.warm_at`` arrives, paying only the residual
    # warm-up instead of a full cold start. The scheduler itself never
    # sets this; the router does, after the warming-soon candidate won
    # the completion-time estimate.
    pending: Optional[Container] = None


class ShabariScheduler:
    def __init__(
        self,
        cluster: Cluster,
        *,
        placement: str = "hashing",  # hashing | packing (Fig. 7b)
        keep_alive_s: float = 600.0,  # OpenWhisk default keep-alive
        route_larger: bool = True,  # Shabari case (2); off = OpenWhisk mode
        background_launch: bool = True,  # Shabari's proactive exact-size spawn
        image_resolver=None,  # function -> ImageSpec; enables the
        # cache-affinity cold rank (None = plain walk, the default)
    ):
        assert placement in ("hashing", "packing")
        self.cluster = cluster
        self.placement = placement
        self.keep_alive_s = keep_alive_s
        self.route_larger = route_larger
        self.background_launch = background_launch
        self.image_resolver = image_resolver
        # md5 home hashing is deterministic per function name; memoize
        # it (and the rotated walk order per home slot — the worker list
        # is fixed for the cluster's lifetime) so the per-placement cost
        # is two dict hits instead of a digest + list build
        self._home_cache: dict = {}
        self._order_cache: dict = {}

    # ------------------------------------------------------------ utils
    def _home_worker(self, function: str) -> int:
        h = self._home_cache.get(function)
        if h is None:
            h = int(hashlib.md5(function.encode()).hexdigest(), 16) % len(
                self.cluster.workers)
            self._home_cache[function] = h
        return h

    def _workers_from_home(self, function: str) -> List[Worker]:
        start = self._home_worker(function)
        order = self._order_cache.get(start)
        if order is None:
            ws = self.cluster.workers
            order = [ws[(start + i) % len(ws)] for i in range(len(ws))]
            self._order_cache[start] = order
        return order

    def _pick_cold_worker(self, function: str, vcpus: int, mem_mb: int) -> Optional[Worker]:
        if self.placement == "hashing":
            order = self._workers_from_home(function)
        else:  # packing: most-loaded first (fill before spilling)
            order = sorted(
                self.cluster.workers, key=lambda w: -(w.used_vcpus + 1e-9)
            )
        # type-aware placement: the first fitting RELIABLE worker in
        # walk order wins; preemptible (spot-tier) workers serve only
        # as a fallback when no reliable worker fits — a cold start
        # seeds the function's warm pool for its whole keep-alive, and
        # pools on reclaimable machines are the ones that vanish.
        # Identical to the plain walk on all-reliable fleets.
        resolver = self.image_resolver
        if resolver is not None:
            return self._pick_cold_affinity(resolver(function), vcpus,
                                            mem_mb, order)
        fallback: Optional[Worker] = None
        for w in order:
            if not w.fits(vcpus, mem_mb):
                continue
            if not w.machine.preemptible:
                return w
            if fallback is None:
                fallback = w
        return fallback

    # a cold placement seeds the function's warm pool on that node for
    # its whole keep-alive; above this post-placement utilization the
    # node is too contended for that pool to be USABLE (warm routing
    # re-checks fits() at request time), so locality there is worthless
    CROWD_FRAC = 0.75

    def _pick_cold_affinity(self, image, vcpus: int, mem_mb: int,
                            order: List[Worker]) -> Optional[Worker]:
        """Cache-affinity cold rank: among fitting workers, minimize the
        residual registry pull (seconds of missing layers), breaking
        ties by walk order — so a free registry (zero pull everywhere)
        degenerates to the plain walk exactly. A worker already past
        CROWD_FRAC utilization is priced as if cache-cold (residual +
        full pull): a warm pool stranded on a saturated node fails the
        fits() check at request time, forfeiting the locality benefit,
        so crowded nodes only win when nothing else is cheaper. Reliable
        workers still dominate the preemptible fallback tier."""
        frac = self.CROWD_FRAC
        best: Optional[Worker] = None
        best_key = None
        fallback: Optional[Worker] = None
        fb_key = None
        for i, w in enumerate(order):
            if not w.fits(vcpus, mem_mb):
                continue
            ic = w.image_cache
            pull = ic.residual_pull_s(image)
            if (w.used_vcpus + vcpus > frac * w.vcpu_limit
                    or w.used_mem_mb + mem_mb > frac * w.total_mem_mb):
                pull += ic.full_pull_s(image)
            key = (pull, i)
            if not w.machine.preemptible:
                if best_key is None or key < best_key:
                    best, best_key = w, key
            elif best is None and (fb_key is None or key < fb_key):
                fallback, fb_key = w, key
        return best if best is not None else fallback

    def cold_candidate(self, function: str, vcpus: int,
                       mem_mb: int) -> Optional[Worker]:
        """Side-effect-free read: the worker a cold start for
        ``function`` at (vcpus, mem_mb) WOULD land on right now, or None
        when no worker fits. The router's estimate mode scores this
        worker's contention aggregates; ``schedule`` makes the same walk
        on the same state, so the answer matches the eventual binding."""
        return self._pick_cold_worker(function, vcpus, mem_mb)

    def warm_candidate(self, function: str, vcpus: int, mem_mb: int,
                       now: float) -> Optional[Container]:
        """Side-effect-free read: the warm container ``schedule`` would
        route this (function, size) to — an exact-size container (LRU
        first, case 1), else the smallest strictly-larger one (case 2,
        only when ``route_larger``), else None. ``schedule`` itself
        binds through this method, so the router's estimate mode scores
        the contention of the worker that will actually serve the
        invocation, not merely *a* warm worker."""
        if self.cluster.legacy_scans:
            # pre-index selection, kept for A/B: materialize the
            # worker-major warm list and stable-sort it
            warm = self.cluster.idle_warm(function, now)
            exact = [c for c in warm if c.vcpus == vcpus and c.mem_mb == mem_mb
                     and c.worker.fits(vcpus, mem_mb)]
            if exact:
                exact.sort(key=lambda c: c.last_used)
                return exact[0]
            if not self.route_larger:
                return None
            larger = [
                c for c in warm
                if c.vcpus >= vcpus and c.mem_mb >= mem_mb
                and c.worker.fits(c.vcpus, c.mem_mb)
            ]
            if not larger:
                return None
            larger.sort(key=lambda c: (c.vcpus - vcpus, c.mem_mb - mem_mb))
            return larger[0]
        # Indexed path: one pass over the cluster's IDLE containers of
        # this function (mark_busy/mark_idle keep that index exact), so
        # busy containers never even surface. Selection parity with the
        # legacy stable sorts: the worker-major warm list is ordered by
        # (wid, cid) — worker list order, then per-worker insertion
        # order, and cids increase with creation time — so "stable sort
        # by k, take first" is exactly "min by (k, wid, cid)". The
        # legacy larger-branch also admits exact-size containers, but
        # an exact-size candidate either passes the identical
        # fits(vcpus, mem_mb) test (then the exact branch wins with its
        # (0, 0) size-delta key anyway) or fails it in both branches —
        # so bucketing exact and strictly-larger separately is safe.
        idle = self.cluster.idle_by_function.get(function)
        if not idle:
            return None
        soa = self.cluster.arrays
        used_v = soa.used_vcpus
        used_m = soa.used_mem_mb
        best_exact = None
        exact_key = None
        best_larger = None
        larger_key = None
        want_larger = self.route_larger
        for c in idle.values():
            if exact_key is not None and c.last_used > exact_key[0]:
                # the index is insertion-ordered and every insertion
                # happens at last_used == sim-now, so last_used is
                # non-decreasing along this iteration: once an exact
                # fit is in hand, only same-last_used ties can still
                # beat it on the (last_used, wid, cid) key
                break
            if c.busy or c.warm_at > now:
                continue
            cv, cm = c.vcpus, c.mem_mb
            if cv < vcpus or cm < mem_mb:
                continue
            w = c.worker
            i = w.sidx
            if cv == vcpus and cm == mem_mb:
                if (used_v[i] + vcpus <= w.vcpu_limit
                        and used_m[i] + mem_mb <= w.total_mem_mb):
                    key = (c.last_used, w.wid, c.cid)
                    if exact_key is None or key < exact_key:
                        best_exact, exact_key = c, key
            elif want_larger and best_exact is None:
                if (used_v[i] + cv <= w.vcpu_limit
                        and used_m[i] + cm <= w.total_mem_mb):
                    key = (cv - vcpus, cm - mem_mb, w.wid, c.cid)
                    if larger_key is None or key < larger_key:
                        best_larger, larger_key = c, key
        if best_exact is not None:
            return best_exact
        return best_larger

    # -------------------------------------------------------- schedule
    def schedule(self, function: str, alloc: Allocation, now: float) -> Decision:
        """Place one invocation. Does not mutate load — the runtime calls
        ``start``/``finish`` as the invocation actually runs."""
        vcpus, mem = alloc.vcpus, alloc.mem_mb

        # (1)/(2) warm routing: exact-size container, else smallest
        # strictly-larger (selection shared with the router's estimate
        # scoring via warm_candidate)
        chosen = self.warm_candidate(function, vcpus, mem, now)
        if chosen is not None:
            if chosen.vcpus == vcpus and chosen.mem_mb == mem:
                return Decision(chosen, cold_start=False,
                                background_launch=None)
            # case 2: proactively launch the exact size in the background
            bg = None
            if self.background_launch:
                w = self._pick_cold_worker(function, vcpus, mem)
                if w is not None:
                    # idle containers carry no load; free to launch now
                    bg = (w, vcpus, mem)
            return Decision(chosen, cold_start=False, background_launch=bg)

        # (3) cold start at the exact size; _pick_cold_worker scanned
        # every worker, so None means no capacity anywhere — queue
        w = self._pick_cold_worker(function, vcpus, mem)
        if w is None:
            return Decision(None, cold_start=True, background_launch=None,
                            queued=True)
        return Decision(None, cold_start=True, background_launch=(w, vcpus, mem))

    # ----------------------------------------------------- lifecycle
    def reap_idle(self, now: float) -> int:
        """Apply the keep-alive policy; returns number reaped."""
        reaped = 0
        for w in self.cluster.workers:
            dead = [
                c for c in w.containers.values()
                if not c.busy and now - c.last_used > self.keep_alive_s
            ]
            for c in dead:
                self.cluster.remove_container(c)
                reaped += 1
        return reaped
