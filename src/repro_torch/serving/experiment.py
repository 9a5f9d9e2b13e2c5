"""End-to-end experiment runner: trace -> policy -> simulator -> summary.

One call reproduces one bar of the paper's Figure 8 (a policy at an RPS).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving import baselines as B
from repro_torch.serving.profiles import build_input_pool, build_profiles
from repro_torch.serving.simulator import (
    InvocationResult,
    SimConfig,
    Simulator,
    summarize,
)
from repro_torch.serving.workload import ScenarioSpec, generate_scenario, generate_trace

POLICIES = (
    "static-medium",
    "static-large",
    "parrotfish",
    "aquatope",
    "cypress",
    "shabari",
    "shabari-openwhisk-sched",  # Fig. 10 ablation: allocator w/o scheduler
    "shabari-proportional",     # Fig. 7a ablation
    "shabari-packing",          # Fig. 7b ablation
)


def make_policy(name: str, profiles, pool, slo_table, seed: int = 0,
                device="cuda"):
    """Build one policy by name. ``device`` places the learning policies'
    CSOAA agents (the baselines hold no tensors and ignore it)."""
    from repro_torch.core.cost_functions import proportional_vcpu_costs

    if name == "static-medium":
        return B.StaticPolicy(12, 3 * 1024, "static-medium")
    if name == "static-large":
        return B.StaticPolicy(20, 5 * 1024, "static-large")
    if name == "parrotfish":
        return B.ParrotfishPolicy(profiles, pool, seed=seed)
    if name == "aquatope":
        return B.AquatopePolicy(
            profiles, pool, lambda fn, idx: slo_table[(fn, idx)], seed=seed
        )
    if name == "cypress":
        return B.CypressPolicy(profiles, pool, seed=seed)
    if name == "shabari":
        return B.ShabariPolicy(device=device)
    if name == "shabari-legacy-engine":
        # the pre-arena allocator path (one small computation per agent
        # per event); allocations are bit-identical to "shabari" —
        # pinned by tests/goldens/legacy-engine/
        p = B.ShabariPolicy(engine="legacy", device=device)
        p.name = "shabari-legacy-engine"
        return p
    if name == "shabari-openwhisk-sched":
        p = B.ShabariPolicy(device=device)
        p.name = "shabari-openwhisk-sched"
        p.uses_shabari_scheduler = False
        return p
    if name == "shabari-proportional":
        p = B.ShabariPolicy(vcpu_cost_fn=proportional_vcpu_costs,
                             device=device)
        p.name = "shabari-proportional"
        return p
    if name == "shabari-packing":
        p = B.ShabariPolicy(device=device)
        p.name = "shabari-packing"
        p.placement = "packing"
        return p
    if name in ("shabari-one-hot", "shabari-per-input-type"):
        return B.FormulationPolicy(name.replace("shabari-", ""), profiles,
                                   device=device)
    raise ValueError(name)


@dataclasses.dataclass
class ExperimentResult:
    policy: str
    rps: float
    summary: Dict[str, float]
    results: List[InvocationResult]
    container_sizes: Dict[str, int]
    # end-to-end chain metrics (Simulator.chain_summary()); None unless
    # the SimConfig enabled cfg.chains
    chain_summary: Optional[Dict[str, float]] = None


def _run_policy_on_trace(
    policy_name: str,
    trace,
    profiles,
    pool,
    slo_table,
    *,
    seed: int,
    rps: float,
    sim_cfg: Optional[SimConfig],
    vcpu_confidence: Optional[int] = None,
    mem_confidence: Optional[int] = None,
    keep_results: bool = False,
    device="cuda",
) -> ExperimentResult:
    """Shared tail of run_experiment/run_scenario: policy -> simulator
    -> summary."""
    policy = make_policy(policy_name, profiles, pool, slo_table, seed=seed,
                         device=device)
    if vcpu_confidence is not None and hasattr(policy, "allocator"):
        policy.allocator.vcpu_confidence = vcpu_confidence
    if mem_confidence is not None and hasattr(policy, "allocator"):
        policy.allocator.mem_confidence = mem_confidence

    # Baselines that keep OpenWhisk's memory-centric load accounting get a
    # per-worker vCPU limit of +inf (vCPUs oversubscribe, §5 reason 3).
    cfg = sim_cfg or SimConfig(seed=seed)
    if not policy.uses_shabari_scheduler:
        cfg = dataclasses.replace(cfg, vcpu_limit=10_000)

    sim = Simulator(
        policy=policy, profiles=profiles, input_pool=pool,
        slo_table=slo_table, cfg=cfg,
    )
    results = sim.run(trace)
    summary = summarize(results)
    sizes = {fn: len(s) for fn, s in sim.container_sizes.items()}
    return ExperimentResult(
        policy=policy_name, rps=rps, summary=summary,
        results=results if keep_results else [],
        container_sizes=sizes,
        chain_summary=sim.chain_summary(),
    )


def run_experiment(
    policy_name: str,
    *,
    rps: float = 4.0,
    duration_s: float = 600.0,
    seed: int = 0,
    slo_multiplier: float = 1.4,
    sim_cfg: Optional[SimConfig] = None,
    vcpu_confidence: Optional[int] = None,
    mem_confidence: Optional[int] = None,
    keep_results: bool = False,
    device="cuda",
) -> ExperimentResult:
    profiles = build_profiles()
    pool = build_input_pool(seed=0)  # input pool fixed across policies
    slo_table = B.build_slo_table(profiles, pool, multiplier=slo_multiplier)
    trace = generate_trace(
        rps=rps,
        functions=sorted(profiles.keys()),
        inputs_per_function={f: len(pool[f]) for f in profiles},
        duration_s=duration_s,
        seed=seed,
    )
    return _run_policy_on_trace(
        policy_name, trace, profiles, pool, slo_table,
        seed=seed, rps=rps, sim_cfg=sim_cfg,
        vcpu_confidence=vcpu_confidence, mem_confidence=mem_confidence,
        keep_results=keep_results, device=device,
    )


# ---------------------------------------------------------------------------
# Scenario-matrix entry point
# ---------------------------------------------------------------------------


def expand_function_clones(
    profiles: Dict,
    pool: Dict,
    slo_table: Dict,
    clones: int,
) -> Tuple[Dict, Dict, Dict]:
    """Clone each function into ``clones`` independently-named aliases
    (``fn``, ``fn::1``, ...) sharing its profile, input pool, and SLOs.

    Aliases behave like distinct functions everywhere identity matters —
    warm-container reuse, home-worker hashing, per-function allocator
    agents — which is how cold-storm gets "many unique rare functions"
    out of the paper's 12 profiled behaviors."""
    if clones <= 1:
        return profiles, pool, slo_table
    P: Dict = {}
    L: Dict = {}
    S: Dict = {}
    for fn in profiles:
        for k in range(clones):
            alias = fn if k == 0 else f"{fn}::{k}"
            P[alias] = profiles[fn]
            L[alias] = pool[fn]
            for idx in range(len(pool[fn])):
                S[(alias, idx)] = slo_table[(fn, idx)]
    return P, L, S


def run_scenario(
    policy_name: str,
    spec: ScenarioSpec,
    *,
    slo_multiplier: float = 1.4,
    sim_cfg: Optional[SimConfig] = None,
    vcpu_confidence: Optional[int] = None,
    mem_confidence: Optional[int] = None,
    keep_results: bool = False,
    device="cuda",
) -> ExperimentResult:
    """Run one (policy, scenario) cell of the evaluation matrix.

    Like :func:`run_experiment` but the trace comes from the scenario
    registry, and cold-storm's ``clones`` param expands the function
    set before policies are built (so offline profilers profile every
    alias, exactly as they would real distinct functions)."""
    profiles = build_profiles()
    pool = build_input_pool(seed=0)  # input pool fixed across policies
    slo_table = B.build_slo_table(profiles, pool, multiplier=slo_multiplier)

    default_clones = 6 if spec.scenario in ("cold-storm",
                                            "registry-storm") else 1
    clones = int(spec.param("clones", default_clones))
    profiles, pool, slo_table = expand_function_clones(
        profiles, pool, slo_table, clones
    )

    trace = generate_scenario(
        spec,
        functions=sorted(profiles.keys()),
        inputs_per_function={f: len(pool[f]) for f in profiles},
    )
    return _run_policy_on_trace(
        policy_name, trace, profiles, pool, slo_table,
        seed=spec.seed, rps=spec.rps, sim_cfg=sim_cfg,
        vcpu_confidence=vcpu_confidence, mem_confidence=mem_confidence,
        keep_results=keep_results, device=device,
    )
