"""Batched CSOAA agent arena: all functions' regressors in stacked tensors.

The port of ``repro/core/agent_arena.py``. Every agent with the same
``(n_classes, dim)`` shape lives as one row of a
``(capacity, n_classes, dim+1)`` weight / AdaGrad tensor pair on the
arena's device (:class:`AgentArena`). Capacity grows by doubling; a
function-name -> row map assigns slots, and released slots are zeroed and
reused.

Completed-invocation feedbacks are queued (:class:`ArenaEngine`) and
flushed lazily. The ordering rule -- pending updates for function F flush
before any predict for F -- keeps served allocations identical to the
sequential path: updates touching distinct rows commute exactly
(disjoint state), and same-row updates are applied in arrival order via
conflict-free passes. Each pass runs as one batched torch computation per
agent group, chunked to at most ``_MAX_BUCKET`` rows and padded to a
power-of-two row count with exact no-op entries, so only a handful of
shapes ever run (the shapes a later CUDA graph would capture).

The reference's NumPy FMA-emulation backend and its calibration are not
ported: they exist only to match XLA's CPU codegen bit for bit. Here the
dot product is written as a left-to-right chain of elementwise multiplies
and adds (:func:`_matvec`), one rounding per operation, so a row's result
does not depend on the batch shape it ran in. That is what makes the
arena and the legacy per-agent path bitwise equal on any device.

Tracing (:mod:`repro_torch.tracing`): the span ``allocator.flush`` over a
flush (``rows``, ``passes``) and ``allocator.predict`` over a prediction's
rows; the counters ``allocator.flush_rows`` and ``allocator.device_reads``
(each copy of the agents' state to the host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import cost_functions as CF

F32 = np.float32

# largest batch ever computed at once: bigger passes are chunked to this
_MAX_BUCKET = 16

# a queue this long is drained even when no predict needs it, so the
# pending list stays bounded through long learning phases
_PENDING_CAP = 256


# ---------------------------------------------------------------------------
# Kernels (torch ops, shared with the legacy OnlineCSC path)
# ---------------------------------------------------------------------------


def _matvec(w: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """``w @ xb`` for w ``(..., n, d1)`` and xb ``(..., d1)`` -> ``(..., n)``,
    summed column by column so every row rounds the same way whatever the
    leading batch shape."""
    xb = xb.unsqueeze(-2)
    acc = w[..., 0] * xb[..., 0]
    for i in range(1, w.shape[-1]):
        acc = acc + w[..., i] * xb[..., i]
    return acc


def _update_core(w, g2, xb, costs, lr: float):
    """One-against-all least-squares AdaGrad step on every class row;
    broadcasts over any leading batch dims."""
    err = _matvec(w, xb) - costs
    grad = err.unsqueeze(-1) * xb.unsqueeze(-2)
    g2 = g2 + grad * grad
    step = lr * grad / (torch.sqrt(g2) + 1e-6)
    return w - step, g2


def _with_bias(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones(1, dtype=x.dtype, device=x.device)])


def _csc_predict(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Predicted cost per class for one agent: ``w @ [x, 1]``."""
    return _matvec(w, _with_bias(x))


def _csc_update(w, g2, x, costs, lr: float):
    return _update_core(w, g2, _with_bias(x), costs, lr)


# ---------------------------------------------------------------------------
# The arena proper
# ---------------------------------------------------------------------------


class AgentArena:
    """Stacked homogeneous agents: one ``(n_classes, dim+1)`` row pair
    per agent in doubling-growth weight/AdaGrad tensors."""

    def __init__(self, n_classes: int, dim: int, *, device, capacity: int = 4):
        self.n_classes = n_classes
        self.dim = dim
        self.w = torch.zeros((capacity, n_classes, dim + 1), dtype=torch.float32,
                             device=device)
        self.g2 = torch.zeros_like(self.w)
        self._slots: Dict[str, int] = {}
        self._free: List[int] = []

    @property
    def capacity(self) -> int:
        return self.w.shape[0]

    def slot(self, name: str) -> int:
        """Row index for ``name``, assigning (and growing) on first use."""
        s = self._slots.get(name)
        if s is not None:
            return s
        if self._free:
            s = self._free.pop()
        else:
            s = len(self._slots)
            if s >= self.capacity:  # grow by doubling
                self.w = torch.cat([self.w, torch.zeros_like(self.w)])
                self.g2 = torch.cat([self.g2, torch.zeros_like(self.g2)])
        self._slots[name] = s
        return s

    def release(self, name: str) -> None:
        """Free ``name``'s row for reuse; the row is zeroed so a future
        tenant starts as a fresh agent (per-function isolation)."""
        s = self._slots.pop(name, None)
        if s is not None:
            self.w[s] = 0.0
            self.g2[s] = 0.0
            self._free.append(s)


@dataclasses.dataclass
class _PendingUpdate:
    function: str
    xb: np.ndarray  # (dim+1,) featurized input with bias, float32
    obs: object  # cost_functions.Observation; costs derived at flush


def _bucket(k: int) -> int:
    return min(1 << (k - 1).bit_length(), _MAX_BUCKET)


class ArenaEngine:
    """The vCPU + memory arena pair behind ``ResourceAllocator``.

    Feedbacks enqueue; predicts flush. A flush drains the queue in
    conflict-free passes (each agent row at most once per pass) and runs
    each pass as batched computations of at most ``_MAX_BUCKET`` rows,
    padded to power-of-two batches with exact no-op entries."""

    def __init__(
        self,
        *,
        n_vcpu_classes: int,
        n_mem_classes: int,
        vcpu_cost_fn: Callable,
        mem_class_mb: int,
        lr: float = 0.5,
        device="cuda",
    ):
        self.n_vcpu_classes = n_vcpu_classes
        self.n_mem_classes = n_mem_classes
        self.vcpu_cost_fn = vcpu_cost_fn
        self.mem_class_mb = mem_class_mb
        self.lr = float(lr)
        self.device = torch.device(device)
        self._vcpu_batch_fn = CF.BATCHED_COST_FNS.get(vcpu_cost_fn)
        self._arenas: Dict[Tuple[int, int], AgentArena] = {}
        self._dims: Dict[str, int] = {}  # function -> feature dim
        self._counts: Dict[str, List[int]] = {}  # eager, incl. pending
        self._pending: List[_PendingUpdate] = []
        # functions with queued updates: a predict forces a flush only
        # when ITS function is in here (updates for other functions touch
        # disjoint rows, so deferring them past this predict is exact)
        self._pending_fns: set = set()

    # ------------------------------------------------------------ slots
    def _arena(self, n_classes: int, dim: int) -> AgentArena:
        key = (n_classes, dim)
        ar = self._arenas.get(key)
        if ar is None:
            ar = AgentArena(n_classes, dim, device=self.device)
            self._arenas[key] = ar
        return ar

    def _dim_of(self, function: str, x: np.ndarray) -> int:
        dim = self._dims.setdefault(function, len(x))
        if dim != len(x):
            raise ValueError(
                f"feature dim changed for {function!r}: {dim} -> {len(x)}"
            )
        return dim

    def updates(self, function: str) -> Tuple[int, int]:
        c = self._counts.get(function)
        return (c[0], c[1]) if c else (0, 0)

    def release(self, function: str) -> None:
        dim = self._dims.pop(function, None)
        self._counts.pop(function, None)
        self._pending = [p for p in self._pending if p.function != function]
        self._pending_fns.discard(function)
        if dim is not None:
            self._arena(self.n_vcpu_classes, dim).release(function)
            self._arena(self.n_mem_classes, dim).release(function)

    # ---------------------------------------------------------- feedback
    def enqueue_update(self, function: str, x: np.ndarray, obs) -> None:
        """Defer one completed-invocation feedback (CSOAA update for both
        agents). It is applied by the next :meth:`flush`, which every
        predict for ``function`` forces first. ``updates()`` counts the
        queued feedback immediately, so confidence thresholds see it
        without a flush."""
        dim = self._dim_of(function, x)
        xb = np.concatenate([np.asarray(x, F32), np.ones(1, F32)])
        self._pending.append(_PendingUpdate(function, xb, obs))
        self._pending_fns.add(function)
        c = self._counts.setdefault(function, [0, 0])
        c[0] += 1
        c[1] += 1
        # make sure slots exist so growth happens off the predict path
        self._arena(self.n_vcpu_classes, dim).slot(function)
        self._arena(self.n_mem_classes, dim).slot(function)

    # ------------------------------------------------------------- flush
    def flush(self) -> None:
        """Apply every pending update. Passes preserve per-function
        order; each pass touches each agent row at most once."""
        pending = self._pending
        if not pending:
            return
        self._pending = []
        self._pending_fns.clear()
        tracing.count("allocator.flush_rows", len(pending))
        with tracing.span("allocator.flush", rows=len(pending)) as sp:
            passes = 0
            while pending:
                seen = set()
                batch: List[_PendingUpdate] = []
                rest: List[_PendingUpdate] = []
                for p in pending:
                    if p.function in seen:
                        rest.append(p)
                    else:
                        seen.add(p.function)
                        batch.append(p)
                self._flush_pass(batch)
                pending = rest
                passes += 1
            sp.set(passes=passes)

    def _cost_matrices(self, batch: Sequence[_PendingUpdate]):
        obs = [p.obs for p in batch]
        # the vectorized variants win only once the batch amortizes their
        # array-building preamble; both produce identical rows
        if len(obs) < 4 or self._vcpu_batch_fn is None:
            vc = np.stack([self.vcpu_cost_fn(o, self.n_vcpu_classes)
                           for o in obs])
            mc = np.stack([CF.memory_costs(o, self.n_mem_classes,
                                           self.mem_class_mb) for o in obs])
        else:
            vc = self._vcpu_batch_fn(obs, self.n_vcpu_classes)
            mc = CF.memory_costs_batch(obs, self.n_mem_classes,
                                       self.mem_class_mb)
        return vc.astype(F32), mc.astype(F32)

    def _flush_pass(self, batch: List[_PendingUpdate]) -> None:
        by_dim: Dict[int, List[int]] = {}
        for i, p in enumerate(batch):
            by_dim.setdefault(len(p.xb) - 1, []).append(i)
        vc, mc = self._cost_matrices(batch)
        for dim, idxs in by_dim.items():
            xbs = np.stack([batch[i].xb for i in idxs])
            for n_classes, costs in ((self.n_vcpu_classes, vc),
                                     (self.n_mem_classes, mc)):
                ar = self._arena(n_classes, dim)
                slots = [ar.slot(batch[i].function) for i in idxs]
                self._update_rows(ar, slots, xbs, costs[idxs])

    def _chunks(self, k: int):
        """(lo, kc, kb): chunks of at most _MAX_BUCKET rows, each padded
        to a power-of-two batch of kb rows."""
        for lo in range(0, k, _MAX_BUCKET):
            kc = min(_MAX_BUCKET, k - lo)
            yield lo, kc, _bucket(kc)

    def _padded(self, rows: np.ndarray, kb: int) -> torch.Tensor:
        out = np.zeros((kb,) + rows.shape[1:], F32)
        out[:len(rows)] = rows
        return torch.from_numpy(out).to(self.device)

    def _update_rows(self, ar: AgentArena, slots: List[int],
                     xbs: np.ndarray, costs: np.ndarray) -> None:
        for lo, kc, kb in self._chunks(len(slots)):
            idx = torch.tensor(slots[lo:lo + kc], device=self.device)
            W = torch.zeros((kb,) + ar.w.shape[1:], dtype=torch.float32,
                            device=self.device)
            G2 = torch.zeros_like(W)
            W[:kc] = ar.w[idx]
            G2[:kc] = ar.g2[idx]
            # padding entries are exact no-ops: zero xb => zero grad =>
            # w/g2 unchanged; padded outputs are discarded below
            nw, ng = _update_core(W, G2, self._padded(xbs[lo:lo + kc], kb),
                                  self._padded(costs[lo:lo + kc], kb), self.lr)
            ar.w[idx] = nw[:kc]
            ar.g2[idx] = ng[:kc]

    def _predict_rows(self, ar: AgentArena, slots: List[int],
                      xbs: np.ndarray) -> List[int]:
        """Arg-min class per row, same bucket/pad/chunk policy as
        :meth:`_update_rows`; ties go to the first index."""
        picks: List[int] = []
        with tracing.span("allocator.predict", rows=len(slots)):
            for lo, kc, kb in self._chunks(len(slots)):
                idx = torch.tensor(slots[lo:lo + kc], device=self.device)
                W = torch.zeros((kb,) + ar.w.shape[1:], dtype=torch.float32,
                                device=self.device)
                W[:kc] = ar.w[idx]
                costs = _matvec(W, self._padded(xbs[lo:lo + kc], kb))
                tracing.count("allocator.device_reads")
                picks += torch.argmin(costs[:kc], dim=-1).tolist()
        return picks

    # ------------------------------------------------------------ predict
    def predict_batch(
        self, items: Sequence[Tuple[str, np.ndarray, bool, bool]]
    ) -> List[Tuple[Optional[int], Optional[int]]]:
        """Arg-min classes for a microbatch of (function, features,
        want_vcpu, want_mem). Flushes pending updates first (the ordering
        rule), then runs all wanted predictions batched per agent group."""
        out: List[List[Optional[int]]] = [[None, None] for _ in items]
        by_dim: Dict[int, List[int]] = {}
        for i, (fn, x, want_v, want_m) in enumerate(items):
            if want_v or want_m:
                by_dim.setdefault(self._dim_of(fn, x), []).append(i)
        if any(items[i][0] in self._pending_fns
               for idxs in by_dim.values() for i in idxs):
            self.flush()
        elif len(self._pending) >= _PENDING_CAP:
            self.flush()
        for dim, idxs in by_dim.items():
            for pos, n_classes in ((0, self.n_vcpu_classes),
                                   (1, self.n_mem_classes)):
                wanted = [i for i in idxs if items[i][2 + pos]]
                if not wanted:
                    continue
                ar = self._arena(n_classes, dim)
                xbs = np.stack([
                    np.concatenate([np.asarray(items[i][1], F32), np.ones(1, F32)])
                    for i in wanted
                ])
                picks = self._predict_rows(
                    ar, [ar.slot(items[i][0]) for i in wanted], xbs)
                for i, c in zip(wanted, picks):
                    out[i][pos] = c
        return [(v, m) for v, m in out]

    def predict(self, function: str, x: np.ndarray, want_vcpu: bool,
                want_mem: bool) -> Tuple[Optional[int], Optional[int]]:
        """Singleton prediction; honors the flush-before-predict rule."""
        return self.predict_batch([(function, x, want_vcpu, want_mem)])[0]

    # ------------------------------------------------------------- debug
    def weights(self, function: str):
        """(vcpu_w, vcpu_g2, mem_w, mem_g2) numpy copies; flushes."""
        self.flush()
        dim = self._dims[function]
        out = []
        for n_classes in (self.n_vcpu_classes, self.n_mem_classes):
            ar = self._arena(n_classes, dim)
            s = ar.slot(function)
            tracing.count("allocator.device_reads", 2)
            out += [ar.w[s].cpu().numpy().copy(), ar.g2[s].cpu().numpy().copy()]
        return tuple(out)
