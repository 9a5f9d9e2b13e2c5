"""Golden-metrics scenarios, as the reference defines them.

One tiny fixed-seed spec per registered scenario, run on a small
4-worker cluster with the full Shabari stack (featurizer -> CSOAA
allocator -> scheduler -> simulator). The reference's ``summarize()``
outputs are committed under ``tests/goldens/<scenario>.json`` (and one
subdirectory per A/B fork below). The port only reads them:
``tests/test_torch_goldens.py`` holds :func:`run_golden` on the CPU to
every snapshot exactly, and ``chip_smoke.py`` does the same with the
agents on the card. The snapshots are written by the reference's
tooling, never from here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.fleet import ClusterSpec, FleetSpec, Link, MachineType, Topology
from repro_torch.core.image_cache import ImageCacheSpec
from repro_torch.serving.chains import default_chains
from repro_torch.serving.experiment import run_scenario
from repro_torch.serving.simulator import SimConfig
from repro_torch.serving.workload import ScenarioSpec, list_scenarios

GOLDEN_POLICY = "shabari"

# The port holds every snapshot with tolerance 0: each summary value
# must equal the committed one exactly, on the CPU and on the card.

# The acquire-on-placement A/B: these scenarios are also snapshotted
# under tests/goldens/legacy-acquire/ with SimConfig(legacy_acquire=
# True), pinning the pre-reservation accounting so the two semantics
# stay independently regression-tested (tests/test_reservation.py).
LEGACY_ACQUIRE_SCENARIOS = ("multi-cluster", "oversubscribe", "poisson-steady")

# The allocator-engine A/B: snapshotted under tests/goldens/
# legacy-engine/ with ResourceAllocator(engine="legacy") — the
# per-object pre-arena path. Unlike the acquire A/B this is NOT a
# semantics fork: the snapshot must equal the main golden bit-for-bit
# (the arena is a pure fast path), which tests/test_agent_arena.py
# asserts, so a numerics drift in either engine trips CI.
LEGACY_ENGINE_SCENARIOS = ("heavy-tail-inputs",)

# The event-loop A/B: snapshotted under tests/goldens/
# legacy-event-loop/ with SimConfig(legacy_event_loop=True) — the
# pre-refactor single-heapq hot loop. Like the engine A/B this is NOT
# a semantics fork: the snapshot must equal the main golden
# bit-for-bit (the array-backed loop + calendar queue is a pure fast
# path), which tests/test_event_loop.py asserts, so drift in either
# loop trips CI. oversubscribe is the pin because its golden exercises
# retries, sheds, and queue timeouts — the event classes the fast
# loop's merge logic reorders most easily if it is wrong.
LEGACY_EVENT_LOOP_SCENARIOS = ("oversubscribe",)

# The completion-time-estimate routing mode: snapshotted under
# tests/goldens/estimate-routing/ with SimConfig(routing="estimate"),
# so the new front-door policy is regression-pinned independently while
# every main golden keeps pinning the default spill-over behavior
# (tests/test_router.py asserts the pin).
ESTIMATE_ROUTING_SCENARIOS = ("multi-cluster",)

# The image-cache A/B: registry-storm's MAIN golden runs with
# SimConfig(image_cache=ImageCacheSpec()) — pull-what's-missing cold
# starts plus cache-affinity placement — and is ALSO snapshotted under
# tests/goldens/cache-disabled/ with image_cache=None, pinning the
# flat-constant cold model on the same trace. This IS a semantics fork
# (cold latencies differ), so the two snapshots are independently
# regression-tested (tests/test_image_cache.py).
CACHE_DISABLED_SCENARIOS = ("registry-storm",)

# The chain-slack A/B: chain-pipeline's MAIN golden runs with
# SimConfig(chain_slack="aware") — per-stage budgets decomposed from
# the end-to-end SLO via critical-path analysis — and is ALSO
# snapshotted under tests/goldens/chain-uniform/ with
# chain_slack="uniform" (flat e2e/depth split per stage). This IS a
# semantics fork (admission and estimate routing see different
# budgets), so the two snapshots are independently regression-tested
# (tests/test_chains.py asserts the pin).
CHAIN_UNIFORM_SCENARIOS = ("chain-pipeline",)


# Heterogeneous-fleet goldens (repro_torch.core.fleet). Both fleets keep the
# main goldens' 4-worker footprint (2 clusters x 2 workers of 32-vCPU/
# 16-GB machines) so metrics stay comparable across scenarios:
#
# * hetero-fleet — cluster 0 is the reference fast tier, cluster 1 a
#   cheap/slow spot tier (half the cores, slower NIC and cold starts,
#   1.35x exec time, preemptible), free links: pins the per-machine
#   cold-curve / contention / exec-factor / preemptible-last paths;
# * wan-spill — uniform fast machines, but the clusters sit across a
#   1 Gb / 50 ms WAN link, under estimate routing: pins transfer
#   charging and the router's transfer pricing on spills.
_GOLDEN_FAST = MachineType(
    name="fast-32c", physical_cores=32, vcpus=32, mem_mb=16 * 1024)
_GOLDEN_SLOW = MachineType(
    name="slow-16c", physical_cores=16, vcpus=32, mem_mb=16 * 1024,
    nic_gbps=5.0, cold_base_s=0.65, cold_per_gb_s=0.18, exec_factor=1.35,
    preemptible=True, price_per_hour=0.4)
_GOLDEN_HETERO_FLEET = FleetSpec(clusters=(
    ClusterSpec(machines=((_GOLDEN_FAST, 2),)),
    ClusterSpec(machines=((_GOLDEN_SLOW, 2),)),
))
_GOLDEN_WAN_FLEET = FleetSpec(
    clusters=(
        ClusterSpec(machines=((_GOLDEN_FAST, 2),)),
        ClusterSpec(machines=((_GOLDEN_FAST, 2),)),
    ),
    topology=Topology(default_link=Link(gbps=1.0, latency_s=0.05)),
)
# registry-storm fleet: same 4-worker/32-vCPU footprint, but each node
# keeps only a 4 GB layer store behind a 2 Gb registry downlink — small
# enough that the clone catalog churns the LRU and slow enough that a
# full pull dwarfs the classic cold curve, so cache-affinity placement
# has real physics to exploit
_GOLDEN_REGISTRY = MachineType(
    name="fast-32c-reg2g", physical_cores=32, vcpus=32, mem_mb=16 * 1024,
    image_store_mb=4 * 1024, registry_gbps=2.0)
_GOLDEN_REGISTRY_FLEET = FleetSpec(
    clusters=(ClusterSpec(machines=((_GOLDEN_REGISTRY, 4),)),))

# per-scenario SimConfig overrides: multi-cluster splits the same
# 4-worker footprint into 2 clusters x 2 workers behind the spill-over
# router, so the golden actually exercises the front door; the two
# fleet scenarios swap in an explicit FleetSpec (which overrides the
# uniform n_clusters/n_workers knobs entirely)
_GOLDEN_SIM_OVERRIDES: Dict[str, Dict] = {
    "multi-cluster": {"n_clusters": 2, "n_workers": 2},
    "hetero-fleet": {"fleet": _GOLDEN_HETERO_FLEET},
    "wan-spill": {"fleet": _GOLDEN_WAN_FLEET, "routing": "estimate"},
    # registry-storm pins the image-cache subsystem: finite per-node
    # layer stores (small enough to churn on the clone catalog) over a
    # slow registry downlink, with cache-affinity placement on
    "registry-storm": {"image_cache": ImageCacheSpec(),
                       "fleet": _GOLDEN_REGISTRY_FLEET},
    # the chain goldens turn the workload dimension on: trigger
    # arrivals start DAG instances and downstream stages are spawned by
    # the simulator. chain-pipeline runs the full slack-aware stack
    # (estimate routing scored against remaining e2e budget + SLO
    # admission with the warm-hold fork); fan-out-join pins the join
    # barrier + fan-out pre-warm under estimate routing alone, so the
    # two goldens localize regressions to different chain subsystems.
    "chain-pipeline": {"chains": (default_chains()["pipeline"],),
                       "routing": "estimate", "admission": "slo"},
    "fan-out-join": {"chains": (default_chains()["fanout"],),
                     "routing": "estimate"},
}


def golden_sim_config(scenario: str = "") -> SimConfig:
    """A deliberately small cluster (4 x 32 vCPU x 16 GB) so contention,
    queueing, and (for oversubscribe) timeouts all actually fire inside
    a two-minute trace. The short queue timeout / slow retry cadence
    keep the saturating scenarios from degenerating into retry storms —
    goldens must stay cheap enough for tier-1."""
    cfg = SimConfig(
        n_workers=4,
        vcpus_per_worker=32,
        physical_cores=32,
        mem_mb_per_worker=16 * 1024,
        vcpu_limit=32,
        retry_interval_s=1.0,
        queue_timeout_s=45.0,
        seed=0,
    )
    return dataclasses.replace(cfg, **_GOLDEN_SIM_OVERRIDES.get(scenario, {}))


# soften the two saturating shapes just enough that a queue backlog
# drains within the golden window (full-strength versions run in
# benchmarks/scenario_matrix.py)
_GOLDEN_PARAMS = {
    "flash-crowd": {"spike_mult": 5.0},
    "oversubscribe": {"load_mult": 2.0},
    "registry-storm": {"spike_mult": 3.0},
}


def golden_specs() -> Dict[str, ScenarioSpec]:
    return {
        name: ScenarioSpec(
            scenario=name, rps=2.0, duration_s=120.0, seed=0,
            params=dict(_GOLDEN_PARAMS.get(name, {})),
        )
        for name in list_scenarios()
    }


def run_golden(scenario: str, *, legacy_acquire: bool = False,
               legacy_engine: bool = False,
               estimate_routing: bool = False,
               legacy_event_loop: bool = False,
               cache_disabled: bool = False,
               chain_uniform: bool = False,
               device="cuda") -> Dict[str, float]:
    spec = golden_specs()[scenario]
    cfg = golden_sim_config(scenario)
    if legacy_acquire:
        cfg = dataclasses.replace(cfg, legacy_acquire=True)
    if estimate_routing:
        cfg = dataclasses.replace(cfg, routing="estimate")
    if legacy_event_loop:
        cfg = dataclasses.replace(cfg, legacy_event_loop=True)
    if cache_disabled:
        cfg = dataclasses.replace(cfg, image_cache=None)
    if chain_uniform:
        cfg = dataclasses.replace(cfg, chain_slack="uniform")
    policy = "shabari-legacy-engine" if legacy_engine else GOLDEN_POLICY
    res = run_scenario(policy, spec, sim_cfg=cfg, device=device)
    summary = res.summary
    if res.chain_summary is not None:
        # chain scenarios fold the end-to-end DAG metrics into the
        # golden (keys are chain_-prefixed, so no collision)
        summary = {**summary, **res.chain_summary}
    return summary


# snapshot subdirectory -> (the run_golden flag it pins, its scenarios)
_FORKS = (
    ("legacy-acquire", "legacy_acquire", LEGACY_ACQUIRE_SCENARIOS),
    ("legacy-engine", "legacy_engine", LEGACY_ENGINE_SCENARIOS),
    ("estimate-routing", "estimate_routing", ESTIMATE_ROUTING_SCENARIOS),
    ("legacy-event-loop", "legacy_event_loop", LEGACY_EVENT_LOOP_SCENARIOS),
    ("cache-disabled", "cache_disabled", CACHE_DISABLED_SCENARIOS),
    ("chain-uniform", "chain_uniform", CHAIN_UNIFORM_SCENARIOS),
)


def golden_cases() -> Dict[str, Tuple[str, Dict[str, bool]]]:
    """Every committed snapshot, by its path under ``tests/goldens/``:
    ``(scenario, run_golden flags)`` -- one per registered scenario plus
    one per scenario of each A/B fork."""
    cases = {f"{name}.json": (name, {}) for name in list_scenarios()}
    for folder, flag, scenarios in _FORKS:
        for name in scenarios:
            cases[f"{folder}/{name}.json"] = (name, {flag: True})
    return cases
