"""Workload generation: the Azure-trace shape (paper §7.1) plus a
registry of named load scenarios.

The paper samples a ten-minute window from the Azure Functions trace
[Shahrad et al. 2020], randomizes start times within each minute, and
subsamples to the target RPS. We reproduce the trace's load shape with
its published characteristics — heavy-tailed per-minute invocation
counts (most functions rare, a few hot) and bursty minutes — using a
seeded generator, then apply exactly the paper's per-minute
start-time randomization and RPS subsampling.

Because allocation quality flips under bursty versus steady load
(Fifer, arXiv 2008.12819; the Freedom/Opportunity study, arXiv
2105.14845), evaluation also needs the other load shapes a production
FaaS sees. ``SCENARIOS`` names them: ``azure`` (the trace shape above),
``poisson-steady``, ``flash-crowd``, ``diurnal``, ``heavy-tail-inputs``,
``cold-storm``, ``oversubscribe`` (the §7.5 study),
``multi-cluster`` (a hot-function surge for the front-door router,
``repro_torch.core.router``), ``hetero-fleet`` (steady skewed load for
machine-type mixes, ``repro_torch.core.fleet``), and ``wan-spill`` (the
hot-surge shape with heavy-tail inputs, where remote placements pay
real transfer time over modeled links). Each generator
is a pure seeded function of a :class:`ScenarioSpec`, so a (spec, seed)
pair always yields the identical ``Arrival`` list.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

_inv_ids = itertools.count()


@dataclasses.dataclass(slots=True)
class Arrival:
    invocation_id: int
    t: float
    function: str
    input_idx: int


def azure_minute_weights(n_minutes: int, rng: np.random.Generator) -> np.ndarray:
    """Per-minute relative load: lognormal bursts around a diurnal-ish
    baseline (the ten-minute windows in the trace show 2-4x swings)."""
    base = 1.0 + 0.3 * np.sin(np.linspace(0, 2 * np.pi, n_minutes))
    burst = rng.lognormal(mean=0.0, sigma=0.45, size=n_minutes)
    w = base * burst
    return w / w.sum()


def function_popularity(functions: Sequence[str], rng: np.random.Generator) -> np.ndarray:
    """Zipf-like popularity — the trace's hallmark (a few functions
    dominate invocations)."""
    ranks = np.arange(1, len(functions) + 1, dtype=np.float64)
    rng.shuffle(ranks)
    w = 1.0 / ranks ** 0.9
    return w / w.sum()


def generate_trace(
    *,
    rps: float,
    functions: Sequence[str],
    inputs_per_function: Dict[str, int],
    duration_s: float = 600.0,
    seed: int = 0,
    uniform_popularity: bool = False,
) -> List[Arrival]:
    rng = np.random.default_rng(seed)
    n_minutes = int(np.ceil(duration_s / 60.0))
    weights = azure_minute_weights(n_minutes, rng)
    total = int(round(rps * duration_s))
    per_minute = rng.multinomial(total, weights)
    if uniform_popularity:
        pop = np.full(len(functions), 1.0 / len(functions))
    else:
        pop = function_popularity(functions, rng)

    arrivals: List[Arrival] = []
    for minute, count in enumerate(per_minute):
        starts = rng.uniform(minute * 60.0, (minute + 1) * 60.0, size=count)
        starts.sort()
        fns = rng.choice(len(functions), size=count, p=pop)
        for t, fi in zip(starts, fns):
            fn = functions[fi]
            idx = int(rng.integers(inputs_per_function[fn]))
            arrivals.append(
                Arrival(next(_inv_ids), float(t), fn, idx)
            )
    arrivals.sort(key=lambda a: a.t)
    return arrivals


# ---------------------------------------------------------------------------
# Scenario matrix
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScenarioSpec:
    """A named, seeded, parameterized load scenario.

    ``params`` carries the scenario-specific knobs (spike multiplier,
    input-skew exponent, clone count, ...); every generator documents
    the keys it reads and their defaults, so an empty ``params`` always
    works.
    """

    scenario: str = "azure"
    rps: float = 4.0
    duration_s: float = 600.0
    seed: int = 0
    params: Dict[str, float] = dataclasses.field(default_factory=dict)

    def param(self, key: str, default: float) -> float:
        return float(self.params.get(key, default))


# generator signature: (spec, functions, inputs_per_function, rng) -> arrivals
ScenarioFn = Callable[
    [ScenarioSpec, List[str], Mapping[str, int], np.random.Generator],
    List["Arrival"],
]

SCENARIOS: Dict[str, ScenarioFn] = {}


def register_scenario(name: str) -> Callable[[ScenarioFn], ScenarioFn]:
    def deco(fn: ScenarioFn) -> ScenarioFn:
        SCENARIOS[name] = fn
        return fn
    return deco


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def generate_scenario(
    spec: ScenarioSpec,
    functions: Sequence[str],
    inputs_per_function: Mapping[str, int],
) -> List[Arrival]:
    """Generate the arrival trace for ``spec``.

    Invocation ids are renumbered 0..n-1 after the final time sort, so
    two calls with the same spec return *identical* Arrival lists
    (unlike the process-global counter ``generate_trace`` keeps for
    backward compatibility).
    """
    try:
        gen = SCENARIOS[spec.scenario]
    except KeyError:
        raise KeyError(
            f"unknown scenario {spec.scenario!r}; known: {list_scenarios()}"
        ) from None
    rng = np.random.default_rng(spec.seed)
    arrivals = gen(spec, list(functions), inputs_per_function, rng)
    arrivals.sort(key=lambda a: a.t)
    for i, a in enumerate(arrivals):
        a.invocation_id = i
    return arrivals


# ------------------------------------------------------------------ helpers
def _poisson_times(rate: float, duration_s: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson arrival times on [0, duration)."""
    if rate <= 0.0 or duration_s <= 0.0:
        return np.empty(0)
    n = int(rng.poisson(rate * duration_s))
    return np.sort(rng.uniform(0.0, duration_s, size=n))


def _thinned_times(rate_fn: Callable[[np.ndarray], np.ndarray],
                   peak_rate: float, duration_s: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Inhomogeneous Poisson via thinning against ``peak_rate``."""
    cand = _poisson_times(peak_rate, duration_s, rng)
    if cand.size == 0:
        return cand
    accept = rate_fn(cand) / peak_rate
    # thinning is only correct when peak_rate bounds rate_fn; a silent
    # clamp here would generate a wrong (too-light) trace
    assert float(accept.max()) <= 1.0 + 1e-9, (
        "rate_fn exceeds peak_rate; thinning bound violated"
    )
    keep = rng.uniform(0.0, 1.0, size=cand.size) < accept
    return cand[keep]


def _assemble(times: np.ndarray, functions: List[str],
              pop: np.ndarray, inputs_per_function: Mapping[str, int],
              rng: np.random.Generator,
              input_weights: Optional[Callable[[int], np.ndarray]] = None,
              ) -> List[Arrival]:
    """Sample (function, input) per arrival time.

    ``input_weights(n)`` returns the idx-sampling distribution for a
    pool of n inputs; None means uniform. Pools are built smallest ->
    largest, so weights skewed toward high indices skew toward large
    inputs.
    """
    out: List[Arrival] = []
    if times.size == 0:
        return out
    fis = rng.choice(len(functions), size=times.size, p=pop)
    for t, fi in zip(times, fis):
        fn = functions[fi]
        n_inputs = inputs_per_function[fn]
        if input_weights is None:
            idx = int(rng.integers(n_inputs))
        else:
            idx = int(rng.choice(n_inputs, p=input_weights(n_inputs)))
        out.append(Arrival(next(_inv_ids), float(t), fn, idx))
    return out


# --------------------------------------------------------------- scenarios
@register_scenario("azure")
def _azure(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """The seed generator: Azure-trace shape (bursty minutes + Zipf
    popularity). params: uniform_popularity (0/1, default 0)."""
    return generate_trace(
        rps=spec.rps, functions=functions,
        inputs_per_function=dict(inputs_per_function),
        duration_s=spec.duration_s, seed=spec.seed,
        uniform_popularity=bool(spec.param("uniform_popularity", 0)),
    )


@register_scenario("azure-24h")
def _azure_24h(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """A full production day at Azure-trace scale, for the ``scale``
    benchmark tier (benchmarks/sim_bench): one diurnal cycle across the
    window (trough at the start, peak mid-window) times the trace's
    lognormal per-minute bursts, Zipf popularity. At the default
    ``peak_mult`` the peak minutes offer several times the fleet's
    serviceable rate, so the cell exercises admission control and
    front-door queueing the way a real overload day does. The whole
    trace is synthesized vectorized at build time — per-minute
    multinomial counts, one uniform draw per arrival — never per-event,
    so a ≥1M-invocation day builds in seconds. params: peak_mult
    (peak-to-trough ratio, default 6.0), burst_sigma (per-minute
    lognormal sigma, default 0.45)."""
    peak_mult = max(spec.param("peak_mult", 6.0), 1.0)
    burst_sigma = spec.param("burst_sigma", 0.45)
    n_minutes = int(np.ceil(spec.duration_s / 60.0))
    # sinusoid from trough 1.0 to peak ``peak_mult`` over one cycle
    phase = 2.0 * np.pi * np.arange(n_minutes) / n_minutes
    base = 1.0 + (peak_mult - 1.0) * 0.5 * (1.0 - np.cos(phase))
    burst = rng.lognormal(mean=0.0, sigma=burst_sigma, size=n_minutes)
    w = base * burst
    w = w / w.sum()
    total = int(round(spec.rps * spec.duration_s))
    per_minute = rng.multinomial(total, w)
    pop = function_popularity(functions, rng)

    m_idx = np.repeat(np.arange(n_minutes), per_minute)
    times = (m_idx + rng.random(total)) * 60.0
    times.sort(kind="stable")
    fis = rng.choice(len(functions), size=total, p=pop)
    n_inputs = np.array([inputs_per_function[f] for f in functions])
    idxs = rng.integers(0, n_inputs[fis])
    return [
        Arrival(next(_inv_ids), float(t), functions[fi], int(ix))
        for t, fi, ix in zip(times, fis, idxs)
    ]


@register_scenario("poisson-steady")
def _poisson_steady(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Memoryless steady load — the opposite pole from azure's bursty
    minutes. params: none."""
    pop = function_popularity(functions, rng)
    times = _poisson_times(spec.rps, spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("flash-crowd")
def _flash_crowd(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Steady baseline with a spike window at ``spike_mult`` x baseline
    RPS (default 8x — Fifer's burst regime). params: spike_mult,
    spike_start_frac (default 0.4), spike_duration_s (default 60)."""
    mult = spec.param("spike_mult", 8.0)
    t0 = spec.param("spike_start_frac", 0.4) * spec.duration_s
    t1 = min(t0 + spec.param("spike_duration_s", 60.0), spec.duration_s)
    pop = function_popularity(functions, rng)

    def rate(t: np.ndarray) -> np.ndarray:
        return np.where((t >= t0) & (t < t1), spec.rps * mult, spec.rps)

    # spike_mult < 1 models a load DIP, so the baseline is the peak
    peak = spec.rps * max(mult, 1.0)
    times = _thinned_times(rate, peak, spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("diurnal")
def _diurnal(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Sinusoidal day/night swing around the mean RPS. params: amp
    (default 0.6), cycles over the window (default 1)."""
    amp = min(max(spec.param("amp", 0.6), 0.0), 0.95)
    cycles = spec.param("cycles", 1.0)
    pop = function_popularity(functions, rng)

    def rate(t: np.ndarray) -> np.ndarray:
        phase = 2.0 * np.pi * cycles * t / spec.duration_s
        return spec.rps * (1.0 + amp * np.sin(phase - np.pi / 2.0))

    times = _thinned_times(rate, spec.rps * (1.0 + amp), spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("heavy-tail-inputs")
def _heavy_tail_inputs(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Steady load whose input-size distribution is skewed to each
    profile's large end (pools are sorted smallest -> largest), probing
    the §2.1 non-linear size->time regime. params: skew (weight
    exponent, default 3.0)."""
    skew = spec.param("skew", 3.0)
    pop = function_popularity(functions, rng)
    times = _poisson_times(spec.rps, spec.duration_s, rng)

    def input_weights(n: int) -> np.ndarray:
        w = (np.arange(1, n + 1, dtype=np.float64)) ** skew
        return w / w.sum()

    return _assemble(times, functions, pop, inputs_per_function, rng,
                     input_weights=input_weights)


@register_scenario("cold-storm")
def _cold_storm(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Many unique, rarely-repeating functions — the keep-alive-defeating
    long tail of the Azure trace. Uniform popularity over the (cloned,
    see ``expand_function_clones``) function set so per-function arrival
    rate stays below warm-hit territory. params: clones (consumed by the
    experiment layer, default 6)."""
    pop = np.full(len(functions), 1.0 / len(functions))
    times = _poisson_times(spec.rps, spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("registry-storm")
def _registry_storm(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Cold-storm over clone aliases that SHARE image base layers (a
    rolling deploy hammering the registry): uniform popularity over the
    cloned function set — every arrival is likely cold — plus a deploy
    -wave window at ``spike_mult`` x baseline, so concurrent pulls pile
    onto the per-node layer stores. The interesting physics lives in
    ``SimConfig(image_cache=...)``: siblings of a pulled clone miss only
    their tiny alias layer, so WHERE a cold start lands decides whether
    it pulls megabytes or gigabytes. params: clones (consumed by the
    experiment layer, default 6), spike_mult (default 4), spike_start
    _frac (default 0.3), spike_duration_s (default 45)."""
    mult = spec.param("spike_mult", 4.0)
    t0 = spec.param("spike_start_frac", 0.3) * spec.duration_s
    t1 = min(t0 + spec.param("spike_duration_s", 45.0), spec.duration_s)
    pop = np.full(len(functions), 1.0 / len(functions))

    def rate(t: np.ndarray) -> np.ndarray:
        return np.where((t >= t0) & (t < t1), spec.rps * mult, spec.rps)

    peak = spec.rps * max(mult, 1.0)
    times = _thinned_times(rate, peak, spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("oversubscribe")
def _oversubscribe(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Offered load beyond cluster vCPUs (the §7.5 study): steady
    arrivals at ``load_mult`` x the nominal RPS, driving queueing,
    retries, and timeouts. params: load_mult (default 3.0)."""
    mult = spec.param("load_mult", 3.0)
    pop = function_popularity(functions, rng)
    times = _poisson_times(spec.rps * mult, spec.duration_s, rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("multi-cluster")
def _multi_cluster(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Hot-spot shape for the front-door router: ``hot_frac`` of traffic
    concentrates on ``hot_fns`` randomly-chosen functions, plus a flash
    window at ``spike_mult`` x baseline. Hashed home clusters pin each
    hot function's warm pool to one cluster, so its cluster saturates
    while the others idle — the regime where spill-over routing (vs pure
    hashing) decides SLO compliance. params: hot_fns (default 2),
    hot_frac (default 0.7), spike_mult (default 4), spike_start_frac
    (default 0.4), spike_duration_s (default 60)."""
    n_hot = max(1, min(int(spec.param("hot_fns", 2)), len(functions)))
    hot_frac = min(max(spec.param("hot_frac", 0.7), 0.0), 1.0)
    hot = rng.choice(len(functions), size=n_hot, replace=False)
    pop = np.full(
        len(functions),
        (1.0 - hot_frac) / max(len(functions) - n_hot, 1),
    )
    pop[hot] = hot_frac / n_hot
    pop = pop / pop.sum()

    mult = spec.param("spike_mult", 4.0)
    t0 = spec.param("spike_start_frac", 0.4) * spec.duration_s
    t1 = min(t0 + spec.param("spike_duration_s", 60.0), spec.duration_s)

    def rate(t: np.ndarray) -> np.ndarray:
        return np.where((t >= t0) & (t < t1), spec.rps * mult, spec.rps)

    times = _thinned_times(rate, spec.rps * max(mult, 1.0), spec.duration_s,
                           rng)
    return _assemble(times, functions, pop, inputs_per_function, rng)


@register_scenario("hetero-fleet")
def _hetero_fleet(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Steady Zipf load with moderately size-skewed inputs — the probe
    shape for heterogeneous fleets (repro_torch.core.fleet): no burst
    dynamics, so metric deltas isolate what per-machine cold curves,
    exec-speed factors, and §5 denominators change about placement.
    Run it under a FleetSpec mixing machine types (the golden pins a
    fast-tier + slow-tier mix). params: skew (input-weight exponent,
    default 2.0)."""
    skew = spec.param("skew", 2.0)
    pop = function_popularity(functions, rng)
    times = _poisson_times(spec.rps, spec.duration_s, rng)

    def input_weights(n: int) -> np.ndarray:
        w = (np.arange(1, n + 1, dtype=np.float64)) ** skew
        return w / w.sum()

    return _assemble(times, functions, pop, inputs_per_function, rng,
                     input_weights=input_weights)


@register_scenario("wan-spill")
def _wan_spill(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Hot-function surge (multi-cluster's shape) with HEAVY-TAIL input
    sizes: the hot functions' home cluster saturates, forcing spills,
    while large inputs make every remote placement pay real transfer
    time over the inter-cluster links (repro_torch.core.fleet.Topology) —
    the regime where transfer-aware estimate routing separates from
    transfer-blind (benchmarks/fleet_bench). params: hot_fns (default
    2), hot_frac (default 0.7), skew (input-weight exponent, default
    3.0), spike_mult (default 4), spike_start_frac (default 0.4),
    spike_duration_s (default 60)."""
    n_hot = max(1, min(int(spec.param("hot_fns", 2)), len(functions)))
    hot_frac = min(max(spec.param("hot_frac", 0.7), 0.0), 1.0)
    hot = rng.choice(len(functions), size=n_hot, replace=False)
    pop = np.full(
        len(functions),
        (1.0 - hot_frac) / max(len(functions) - n_hot, 1),
    )
    pop[hot] = hot_frac / n_hot
    pop = pop / pop.sum()

    mult = spec.param("spike_mult", 4.0)
    t0 = spec.param("spike_start_frac", 0.4) * spec.duration_s
    t1 = min(t0 + spec.param("spike_duration_s", 60.0), spec.duration_s)
    skew = spec.param("skew", 3.0)

    def rate(t: np.ndarray) -> np.ndarray:
        return np.where((t >= t0) & (t < t1), spec.rps * mult, spec.rps)

    def input_weights(n: int) -> np.ndarray:
        w = (np.arange(1, n + 1, dtype=np.float64)) ** skew
        return w / w.sum()

    times = _thinned_times(rate, spec.rps * max(mult, 1.0), spec.duration_s,
                           rng)
    return _assemble(times, functions, pop, inputs_per_function, rng,
                     input_weights=input_weights)


def _chain_trace(chain_name: str, idx_cap_default: float,
                 spec: ScenarioSpec, functions, inputs_per_function,
                 rng: np.random.Generator) -> List[Arrival]:
    """Shared shape for the chain scenarios: a Poisson TRIGGER stream
    on the chain's root function plus background Zipf traffic over the
    remaining functions.

    The trace only carries the trigger arrivals — every downstream
    stage invocation is SPAWNED by the simulator when its parents
    complete (``SimConfig.chains``; the golden harness wires
    ``repro_torch.serving.chains.default_chains()``). Background traffic
    excludes the trigger function so the chain count is exactly the
    trigger count, and it keeps the non-chain warm pools busy enough
    that slack decisions have real competition for capacity.

    params: trigger_frac (fraction of ``spec.rps`` that starts chains,
    default 0.4), trigger_idx_cap (exclusive upper bound on the trigger
    input idx — pools sort smallest -> largest and the root stage's
    expected_s is calibrated to a mid-pool input, so the cap keeps
    huge-input roots from swamping the critical-path math; per-scenario
    default).
    """
    from repro_torch.serving.chains import chain_trigger, default_chains

    trig = chain_trigger(default_chains()[chain_name])
    frac = min(max(spec.param("trigger_frac", 0.4), 0.0), 1.0)
    cap = int(spec.param("trigger_idx_cap", idx_cap_default))

    out: List[Arrival] = []
    n_inputs = inputs_per_function[trig]
    hi = max(1, min(cap, n_inputs))
    for t in _poisson_times(frac * spec.rps, spec.duration_s, rng):
        idx = int(rng.integers(hi))
        out.append(Arrival(next(_inv_ids), float(t), trig, idx))

    bg = [f for f in functions if f != trig]
    if bg:
        pop = function_popularity(bg, rng)
        times = _poisson_times((1.0 - frac) * spec.rps, spec.duration_s,
                               rng)
        out.extend(_assemble(times, bg, pop, inputs_per_function, rng))
    return out


@register_scenario("chain-pipeline")
def _chain_pipeline(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Linear 4-stage media-ETL chain (``default_chains()["pipeline"]``:
    imageprocess -> mobilenet -> resnet50 -> compress) under background
    Zipf load. The root is imageprocess, whose input pool spans ~0.1s
    to ~9s of exec — the default idx cap (11 of 14) trims the extreme
    tail so the e2e SLO (slo_mult x critical path) stays meaningful.
    params: see ``_chain_trace``."""
    return _chain_trace("pipeline", 11.0, spec, functions,
                        inputs_per_function, rng)


@register_scenario("fan-out-join")
def _fan_out_join(spec: ScenarioSpec, functions, inputs_per_function, rng):
    """Fan-out/fan-in chain (``default_chains()["fanout"]``: qr
    validates, then thumb/detect/tag run in parallel, and a sentiment
    digest joins all three) under background Zipf load. The join
    barrier makes the digest's arrival time the max of three sibling
    completions, so one slow sibling decides e2e latency — the shape
    where per-stage slack differs most from a uniform SLO split. qr's
    pool is uniformly cheap, so no idx cap by default. params: see
    ``_chain_trace``."""
    return _chain_trace("fanout", 1e9, spec, functions,
                        inputs_per_function, rng)
