"""Heterogeneous fleet + network topology as first-class objects.

Until this layer existed, every worker in the simulation was an
identical 96-core/10 Gb clone of the paper's §7.1 testbed node and
moving an invocation's input payload to a remote cluster was free.
Both assumptions make the completion-time estimates behind
``routing="estimate"`` and ``admission="slo"`` systematically dishonest
the moment the fleet is not uniform: a "cheap-but-far" placement looks
exactly as good as an "expensive-but-near" one (the price-performance
axis Bilal et al., arXiv 2105.14845, show is where the real wins live),
and spilling a 900 MB heavy-tail input across a WAN link costs nothing.

This module supplies the missing vocabulary, in the shape cluster
simulators like Helix use (machine types and network links as
simulation objects with per-link transmission times):

* :class:`MachineType` — the per-worker hardware contract: physical
  cores and NIC bandwidth (the §5 contention denominators), advertised
  vCPUs / memory / oversubscription limit, the cold-start latency curve
  (container create cost is hardware-dependent), an execution speed
  factor relative to the reference machine, and an optional
  preemptible/price tier for spot-style scheduling policies;
* :class:`Link` / :class:`Topology` — inter-cluster bandwidth/latency.
  An invocation's input payload lives in its HOME cluster's object
  store; a remote placement first moves the payload over the link, so
  :meth:`Topology.transfer_s` is the arrival→cluster transfer time the
  runtime charges (and the router prices) on spills;
* :class:`ClusterSpec` / :class:`FleetSpec` — the composition: ordered
  machine groups per cluster plus the topology between clusters.

The DEFAULT fleet — one uniform machine type built from the
:class:`~repro_torch.serving.simulator.SimConfig` constants, zero-cost links
(:meth:`Topology.is_free`) — reproduces the homogeneous behavior
bit-for-bit: every golden snapshot is byte-identical with
``SimConfig(fleet=None)``, the same A/B discipline as ``legacy_scans``/
``legacy_acquire``. The FleetSpec is also the single source of the §5
model constants: the simulator charges and the router forecasts from
the SAME ``MachineType`` carried on each ``Worker``, so the two can no
longer drift apart through parallel constructor arguments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.image_cache import ImageSpec

#: §7.1 testbed node — the reference machine every exec_factor is
#: relative to, and the defaults SimConfig mirrors.
REF_PHYSICAL_CORES = 96
REF_VCPUS = 90
REF_MEM_MB = 125 * 1024
REF_NIC_GBPS = 10.0
REF_COLD_BASE_S = 0.45
REF_COLD_PER_GB_S = 0.12
#: per-node container-image layer store and registry downlink (only
#: consulted when ``SimConfig(image_cache=...)`` is enabled)
REF_IMAGE_STORE_MB = 20.0 * 1024
REF_REGISTRY_GBPS = 10.0

#: Lognormal jitter the simulator multiplies into every cold-start
#: draw, and its expectation E[lognormal(0, s)] = exp(s^2/2) — the
#: factor the router prices so the estimator matches the runtime's
#: mean, not its median (tests/test_image_cache.py pins the two).
COLD_JITTER_SIGMA = 0.15
COLD_JITTER_MEAN = math.exp(0.5 * COLD_JITTER_SIGMA ** 2)


@dataclasses.dataclass(frozen=True)
class MachineType:
    """One worker hardware configuration.

    ``exec_factor`` scales UNCONTENDED execution time relative to the
    reference machine (>1 = slower silicon); profiles stay
    machine-independent and calibration (``Router.observe_exec``) is
    fed reference-normalized times, so one estimator serves every type.
    ``preemptible``/``price_per_hour`` are the spot-tier metadata:
    placement prefers reliable workers (see ``ShabariScheduler``) and
    price-performance sweeps can cost a fleet without re-deriving it.
    """

    name: str = "ref-96c"
    physical_cores: int = REF_PHYSICAL_CORES
    vcpus: int = REF_VCPUS
    mem_mb: int = REF_MEM_MB
    nic_gbps: float = REF_NIC_GBPS
    cold_base_s: float = REF_COLD_BASE_S
    cold_per_gb_s: float = REF_COLD_PER_GB_S
    exec_factor: float = 1.0
    # per-worker oversubscription cap (the §6 userCPU knob); None means
    # cap at the advertised vCPUs
    vcpu_limit: Optional[int] = None
    preemptible: bool = False
    price_per_hour: float = 1.0
    # container-image layer store size and registry downlink; inert
    # unless SimConfig(image_cache=...) is set (flat-constant cold
    # starts otherwise)
    image_store_mb: float = REF_IMAGE_STORE_MB
    registry_gbps: float = REF_REGISTRY_GBPS

    @property
    def limit(self) -> int:
        return self.vcpus if self.vcpu_limit is None else self.vcpu_limit

    def cold_latency_s(self, mem_mb: int) -> float:
        """Mean-field container-create latency for this machine (the
        simulator multiplies in its lognormal jitter; the router uses
        the mean as-is)."""
        return self.cold_base_s + self.cold_per_gb_s * mem_mb / 1024.0


@dataclasses.dataclass(frozen=True)
class Link:
    """An inter-cluster network link. The default is free (infinite
    bandwidth, zero latency) — the homogeneous-world assumption, kept
    as the default so ``Topology()`` is the exact no-op."""

    gbps: float = math.inf
    latency_s: float = 0.0

    def transfer_s(self, mb: float) -> float:
        if mb <= 0.0:
            return self.latency_s
        return self.latency_s + mb * 0.008 / self.gbps


@dataclasses.dataclass(frozen=True)
class Topology:
    """Pairwise inter-cluster links. Lookups are symmetric — a link
    registered as (i, j) also serves (j, i) — and fall back to
    ``default_link`` for unlisted pairs. Intra-cluster transfer is
    always free (the payload is already in the cluster's object
    store)."""

    default_link: Link = Link()
    links: Tuple[Tuple[Tuple[int, int], Link], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "_table",
            {frozenset(pair): link for pair, link in self.links},
        )

    def link(self, a: int, b: int) -> Link:
        if a == b:
            return Link()
        return self._table.get(frozenset((a, b)), self.default_link)

    def transfer_s(self, src: int, dst: int, mb: float) -> float:
        """Input-payload transfer time for placing an invocation whose
        payload lives in cluster ``src`` onto cluster ``dst``."""
        if src == dst:
            return 0.0
        return self.link(src, dst).transfer_s(mb)

    def is_free(self) -> bool:
        """True when every link is zero-cost — the homogeneous-world
        fast path: the runtime skips transfer charging entirely, so
        default-fleet event streams are bit-identical to pre-topology
        behavior."""
        return all(
            link.latency_s == 0.0 and math.isinf(link.gbps)
            for link in (self.default_link, *(l for _, l in self.links))
        )


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Ordered machine groups composing one cluster: ((type, count),
    ...). Worker ids within the cluster follow group order, so the
    scheduler's home-hash walk sees a deterministic type layout."""

    machines: Tuple[Tuple[MachineType, int], ...]

    @property
    def n_workers(self) -> int:
        return sum(count for _, count in self.machines)

    def worker_machines(self) -> Tuple[MachineType, ...]:
        out = []
        for machine, count in self.machines:
            out.extend([machine] * count)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The whole deployment: clusters (each a machine-group mix) plus
    the network topology between them. ``SimConfig(fleet=...)``
    overrides the uniform n_clusters/n_workers knobs entirely."""

    clusters: Tuple[ClusterSpec, ...]
    topology: Topology = Topology()
    # optional function -> ImageSpec assignments carried with the
    # deployment (tuple of (function, ImageSpec) pairs, hashable);
    # consulted only when SimConfig(image_cache=...) is enabled and the
    # ImageCacheSpec doesn't override them
    images: Tuple[Tuple[str, ImageSpec], ...] = ()

    @property
    def n_clusters(self) -> int:
        return len(self.clusters)

    @staticmethod
    def uniform(n_clusters: int, n_workers: int,
                machine: MachineType,
                topology: Optional[Topology] = None) -> "FleetSpec":
        """The homogeneous fleet: ``n_clusters`` x ``n_workers`` of one
        machine type, free links unless ``topology`` says otherwise."""
        spec = ClusterSpec(machines=((machine, n_workers),))
        return FleetSpec(
            clusters=tuple(spec for _ in range(n_clusters)),
            topology=topology or Topology(),
        )

    def price_per_hour(self) -> float:
        """Fleet cost rate — the denominator of any price-performance
        metric (benchmarks/fleet_bench)."""
        return sum(
            machine.price_per_hour * count
            for cl in self.clusters for machine, count in cl.machines
        )
