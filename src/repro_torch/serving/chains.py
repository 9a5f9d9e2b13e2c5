"""Function chains / DAG workloads — the first structural change to
*what an invocation is* since the seed.

Production serverless traffic is dominated by multi-stage pipelines
(ML inference chains, ETL DAGs), and Shabari's delay-decisions-until-
input insight sharpens at stage boundaries: when stage N completes,
the router knows BOTH the payload stage N+1 will receive (the sum of
its parents' outputs) and the chain's remaining end-to-end budget —
neither of which exists for an independent invocation. Fifer (arXiv
2008.12819) shows what that knowledge buys: slack-aware per-stage
scheduling (a stage with slack tolerates a cold start or a queue hold;
a critical-path stage gets warm-priority placement) plus proactive
pre-warming of downstream containers from upstream admission counts.

This module supplies the spec and runtime state machine; the simulator
owns events and ids (``SimConfig.chains`` wires it in — ``None``, the
default, touches nothing):

* :class:`ChainSpec` — a DAG of named stages over the paper's 12
  profiled functions, per-edge payload sizes (MB), per-stage expected
  durations, and an end-to-end SLO expressed as ``slo_mult`` x the
  critical path;
* critical-path slack decomposition — ``stage_budget`` turns the
  remaining end-to-end budget into a per-stage allowance by reserving
  the longest expected path BELOW the stage (``chain_slack="aware"``),
  or splits the e2e SLO uniformly per stage for the slack-blind A/B
  arm (``"uniform"``, benchmarks/chain_bench);
* join barriers — a fan-in stage spawns only when its LAST parent
  completes; its input is the pool entry nearest the summed in-edge
  payloads, so exec models, NIC demand, transfer pricing, and the ECT
  regressor all see a consistent input size;
* Fifer-style pre-warm counts — ``note_start``/``note_end`` track how
  many running stage-N invocations will feed each stage-N+1 function,
  which the simulator compares against the idle warm/warming supply to
  decide proactive launches through the existing warming-soon index.

Every trace arrival of a spec's TRIGGER function (its root stage's
function) starts one chain instance; scenario generators keep trigger
functions out of their background traffic so the chain population is
exactly the trigger stream.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.profiles import input_size_mb


@dataclasses.dataclass(frozen=True)
class ChainStage:
    """One DAG node: a unique stage name bound to a profiled function."""

    name: str
    function: str


@dataclasses.dataclass(frozen=True)
class ChainEdge:
    """``src`` stage's output feeds ``dst``; ``payload_mb`` is the size
    of that output (a fan-in stage's input is the sum over in-edges)."""

    src: str
    dst: str
    payload_mb: float


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """A DAG workload spec. ``expected_s`` carries author-time expected
    per-stage durations (uncontended seconds at a typical allocation) —
    they shape the slack DECOMPOSITION and the end-to-end SLO
    (``slo_mult`` x the critical path), not the simulated physics,
    which come from the real profiles as for any invocation."""

    name: str
    stages: Tuple[ChainStage, ...]
    edges: Tuple[ChainEdge, ...]
    expected_s: Tuple[Tuple[str, float], ...]
    slo_mult: float = 1.5


class _Compiled:
    """Derived DAG facts, computed once per spec."""

    __slots__ = ("spec", "root", "fn", "children", "n_parents",
                 "input_idx", "cp_after", "cp_total", "depth", "e2e_slo",
                 "n_stages")

    def __init__(self, spec: ChainSpec, input_pool: Dict[str, List[Dict]]):
        names = [s.name for s in spec.stages]
        assert len(set(names)) == len(names), f"duplicate stage in {spec.name}"
        self.spec = spec
        self.fn = {s.name: s.function for s in spec.stages}
        self.children: Dict[str, List[Tuple[str, float]]] = {
            n: [] for n in names}
        self.n_parents: Dict[str, int] = {n: 0 for n in names}
        in_mb: Dict[str, float] = {n: 0.0 for n in names}
        for e in spec.edges:
            assert e.src in self.fn and e.dst in self.fn, (spec.name, e)
            self.children[e.src].append((e.dst, e.payload_mb))
            self.n_parents[e.dst] += 1
            in_mb[e.dst] += e.payload_mb
        roots = [n for n in names if self.n_parents[n] == 0]
        assert len(roots) == 1, (
            f"chain {spec.name!r} must have exactly one root, got {roots}")
        self.root = roots[0]
        self.n_stages = len(names)

        # longest expected-duration path from each stage to a sink —
        # memoized DFS; the "in progress" sentinel catches cycles
        exp = dict(spec.expected_s)
        assert set(exp) == set(names), (
            f"chain {spec.name!r}: expected_s must cover every stage")
        cp_from: Dict[str, float] = {}
        depth_from: Dict[str, int] = {}

        def walk(n: str) -> float:
            got = cp_from.get(n)
            if got == -1.0:
                raise ValueError(f"chain {spec.name!r} has a cycle at {n!r}")
            if got is not None:
                return got
            cp_from[n] = -1.0
            best, deep = 0.0, 0
            for child, _ in self.children[n]:
                c = walk(child)
                best = max(best, c)
                deep = max(deep, depth_from[child])
            cp_from[n] = exp[n] + best
            depth_from[n] = 1 + deep
            return cp_from[n]

        self.cp_total = walk(self.root)
        assert len(cp_from) == len(names), (
            f"chain {spec.name!r}: stages unreachable from the root: "
            f"{sorted(set(names) - set(cp_from))}")
        # slack reserved BELOW each stage (the stage's own expected time
        # is part of ITS allowance, not its descendants')
        self.cp_after = {n: cp_from[n] - exp[n] for n in names}
        self.depth = depth_from[self.root]
        self.e2e_slo = spec.slo_mult * self.cp_total

        # fan-in input resolution: a spawned stage runs the pool entry
        # whose input size is nearest the summed in-edge payloads, so
        # the exec model, NIC demand, featurizer, and ECT regressor all
        # see one consistent input (deterministic: ties -> lower idx)
        self.input_idx: Dict[str, int] = {}
        for n in names:
            if n == self.root:
                continue
            pool = input_pool[self.fn[n]]
            sizes = [input_size_mb(self.fn[n], meta) for meta in pool]
            self.input_idx[n] = int(np.argmin(
                [abs(s - in_mb[n]) for s in sizes]))


@dataclasses.dataclass(slots=True)
class _Instance:
    """One live chain: join-barrier counters + stage timestamps."""

    comp: _Compiled
    root_t: float
    stage_t: Dict[str, float]
    waiting: Dict[str, int]
    done: int = 0
    failed: bool = False


class ChainRuntime:
    """The simulator-facing state machine. The simulator owns events,
    ids, and Arrival construction; this class owns instance state,
    join barriers, budgets, pre-warm counts, and end-to-end stats."""

    def __init__(self, specs, input_pool: Dict[str, List[Dict]],
                 *, slack: str = "aware"):
        assert slack in ("aware", "uniform"), slack
        self.slack = slack
        self._compiled: Dict[str, _Compiled] = {}
        for spec in specs:
            comp = _Compiled(spec, input_pool)
            trig = comp.fn[comp.root]
            assert trig not in self._compiled, (
                f"two chains share trigger function {trig!r}")
            self._compiled[trig] = comp
        self._by_iid: Dict[int, Tuple[_Instance, str]] = {}
        # Fifer pre-warm signal: running parent invocations per child
        # FUNCTION (stage-N admissions that will fan into stage N+1)
        self._inflight: Dict[str, int] = {}
        self.started = 0
        self.completed = 0
        self.failed = 0
        self.late = 0
        self.stage_spawned = 0
        self._e2e: List[float] = []

    def triggers(self) -> List[str]:
        return sorted(self._compiled)

    # ----------------------------------------------------------- budgets
    def stage_budget(self, arrival, now: float, first_seen: float
                     ) -> Optional[Tuple[float, Optional[float]]]:
        """Per-stage SLO allowance for a (possibly retried) arrival, as
        ``(slo_s, budget_s)`` — ``slo_s`` feeds admission, ``budget_s``
        feeds slack-aware estimate routing (None = slack-blind).
        Returns None for non-chain traffic. First sight of a trigger
        -function arrival registers a new chain instance (idempotent
        across retries: the id stays mapped).

        * ``aware``: remaining e2e budget minus the longest expected
          path below this stage — a critical-path stage gets exactly
          what the chain can still afford, an off-path stage inherits
          the join's slack;
        * ``uniform``: the slack-blind baseline — e2e SLO split evenly
          over the critical path's depth, measured from the STAGE's own
          arrival, with no routing budget."""
        ent = self._by_iid.get(arrival.invocation_id)
        if ent is None:
            comp = self._compiled.get(arrival.function)
            if comp is None:
                return None
            inst = _Instance(comp=comp, root_t=first_seen,
                             stage_t={comp.root: first_seen},
                             waiting=dict(comp.n_parents))
            self._by_iid[arrival.invocation_id] = ent = (inst, comp.root)
            self.started += 1
        inst, stage = ent
        comp = inst.comp
        if self.slack == "aware":
            b = comp.e2e_slo - (now - inst.root_t) - comp.cp_after[stage]
            return (b, b)
        return (comp.e2e_slo / comp.depth - (now - inst.stage_t[stage]),
                None)

    # ---------------------------------------------------------- pre-warm
    def note_start(self, iid: int) -> List[Tuple[str, int]]:
        """A stage invocation started running: bump the in-flight count
        of every child function it will feed. Returns ``[(child_fn,
        inflight)]`` so the simulator can compare demand against the
        idle warm/warming supply and pre-warm the shortfall."""
        ent = self._by_iid.get(iid)
        if ent is None:
            return []
        inst, stage = ent
        out = []
        for child, _mb in inst.comp.children[stage]:
            fn = inst.comp.fn[child]
            n = self._inflight[fn] = self._inflight.get(fn, 0) + 1
            out.append((fn, n))
        return out

    def note_end(self, iid: int) -> None:
        """Mirror of ``note_start`` at finish (normal or OOM)."""
        ent = self._by_iid.get(iid)
        if ent is None:
            return
        inst, stage = ent
        for child, _mb in inst.comp.children[stage]:
            fn = inst.comp.fn[child]
            self._inflight[fn] = self._inflight.get(fn, 1) - 1

    # ------------------------------------------------------- transitions
    def on_complete(self, iid: int, now: float
                    ) -> List[Tuple[_Instance, str, str, int]]:
        """A stage invocation finished successfully. Decrements child
        join barriers and returns the stages whose LAST parent this
        was, as ``(instance, stage_name, function, input_idx)`` — the
        simulator mints an invocation id, builds the Arrival, and calls
        :meth:`bind`. A failed instance spawns nothing (its joins can
        never be satisfied anyway); chain completion is recorded when
        every stage has finished."""
        ent = self._by_iid.get(iid)
        if ent is None:
            return []
        inst, stage = ent
        inst.done += 1
        ready: List[Tuple[_Instance, str, str, int]] = []
        comp = inst.comp
        if not inst.failed:
            for child, _mb in comp.children[stage]:
                inst.waiting[child] -= 1
                if inst.waiting[child] == 0:
                    ready.append((inst, child, comp.fn[child],
                                  comp.input_idx[child]))
            if inst.done == comp.n_stages:
                self.completed += 1
                e2e = now - inst.root_t
                self._e2e.append(e2e)
                if e2e > comp.e2e_slo + 1e-9:
                    self.late += 1
        return ready

    def bind(self, inst: _Instance, stage: str, iid: int,
             now: float) -> None:
        """Register a freshly-spawned downstream stage invocation."""
        self._by_iid[iid] = (inst, stage)
        inst.stage_t[stage] = now
        self.stage_spawned += 1

    def on_fail(self, iid: int) -> None:
        """A stage invocation will never complete (shed, queue timeout,
        or OOM kill): the whole chain instance fails, once."""
        ent = self._by_iid.get(iid)
        if ent is not None and not ent[0].failed:
            ent[0].failed = True
            self.failed += 1

    # ------------------------------------------------------------- stats
    def summary(self) -> Dict[str, float]:
        """End-to-end chain metrics (merged into chain-scenario goldens
        and the chain_bench rows). ``chain_e2e_viol_pct`` counts BOTH
        late completions and failed instances against starts — a shed
        or OOM-killed stage is an e2e miss, not a statistical dropout."""
        e2e = np.array(self._e2e) if self._e2e else np.empty(0)
        started = max(self.started, 1)
        return {
            "chain_started": float(self.started),
            "chain_completed": float(self.completed),
            "chain_failed": float(self.failed),
            "chain_stage_spawned": float(self.stage_spawned),
            "chain_e2e_viol_pct": 100.0 * (self.late + self.failed) / started,
            "chain_e2e_p50_s": float(np.percentile(e2e, 50)) if e2e.size else 0.0,
            "chain_e2e_p99_s": float(np.percentile(e2e, 99)) if e2e.size else 0.0,
        }


# ---------------------------------------------------------------------------
# Canonical specs (the chain-pipeline / fan-out-join scenarios)
# ---------------------------------------------------------------------------


def chain_trigger(spec: ChainSpec) -> str:
    """The spec's trigger function (root stage's function) without
    compiling against a pool."""
    dsts = {e.dst for e in spec.edges}
    roots = [s for s in spec.stages if s.name not in dsts]
    assert len(roots) == 1, spec.name
    return roots[0].function


def default_chains() -> Dict[str, ChainSpec]:
    """The two committed DAGs. ``expected_s`` values are the
    uncontended exec times of each stage's resolved input at a typical
    (8 vCPU) allocation, rounded — they set the slack decomposition
    ratios and the e2e SLO (``slo_mult`` x critical path), while the
    simulated physics come from the live profiles.

    * ``pipeline`` (media-etl) — a linear 4-stage media pipeline:
      image ingest -> mobilenet detect -> resnet50 classify -> archive
      compression. Every stage is on the critical path, so "aware"
      budgets equal remaining-e2e-minus-tail while "uniform" starves
      the expensive classify stage and over-serves ingest;
    * ``fanout`` (fan-out-join) — a cheap qr-decode trigger fans out to
      three parallel analyses (imageprocess / mobilenet / resnet50)
      whose outputs join in a sentiment digest. The thumb branch
      (~1 s) holds ~2.4 s of slack against the tag branch (~3.4 s) —
      exactly the asymmetry slack-aware budgets exploit."""
    pipeline = ChainSpec(
        name="media-etl",
        stages=(
            ChainStage("ingest", "imageprocess"),
            ChainStage("detect", "mobilenet"),
            ChainStage("classify", "resnet50"),
            ChainStage("archive", "compress"),
        ),
        edges=(
            ChainEdge("ingest", "detect", 1.2),
            ChainEdge("detect", "classify", 1.2),
            ChainEdge("classify", "archive", 0.5),
        ),
        expected_s=(
            ("ingest", 1.0),
            ("detect", 2.0),
            ("classify", 3.4),
            ("archive", 1.8),
        ),
        slo_mult=1.6,
    )
    fanout = ChainSpec(
        name="fanout-ml",
        stages=(
            ChainStage("validate", "qr"),
            ChainStage("thumb", "imageprocess"),
            ChainStage("detect", "mobilenet"),
            ChainStage("tag", "resnet50"),
            ChainStage("digest", "sentiment"),
        ),
        edges=(
            ChainEdge("validate", "thumb", 0.9),
            ChainEdge("validate", "detect", 0.9),
            ChainEdge("validate", "tag", 0.9),
            ChainEdge("thumb", "digest", 0.008),
            ChainEdge("detect", "digest", 0.006),
            ChainEdge("tag", "digest", 0.006),
        ),
        expected_s=(
            ("validate", 0.15),
            ("thumb", 1.0),
            ("detect", 2.0),
            ("tag", 3.4),
            ("digest", 2.1),
        ),
        slo_mult=1.6,
    )
    return {"pipeline": pipeline, "fanout": fanout}
