"""The one traffic generator: a mix file of parameters in, invocations out.

A mix (``traffic/<name>.json``) gives distributions of the batch, the
prompt lengths and the new tokens, the loop (``open``: Poisson arrivals
at the cell's rate; ``closed``: callers replaying a fixed set of
documents), and how to balance the order. The generator keeps the work
of a run the same for every seed:

* the shapes (batch, prompt lengths, new tokens) are a fixed multiset,
  drawn once from the mix's ``shape_seed``: exact shares of each batch
  and new-token value, prompt lengths at evenly spaced quantiles of their
  distribution;
* the gaps between arrivals are the quantiles of the exponential
  distribution, scaled to fill the window exactly;
* both are put in one balanced cycle, also from ``shape_seed``: blocks
  that each take one item from every stratum of cost (or of gap), so a
  block of consecutive invocations has the mix's spread of cost;
* ``--seed`` picks where in the cycle the run starts (shapes and gaps
  turn together) and draws every token id.

So two seeds send the same sizes and arrivals in another order, and the
queue sees the same sequence of loads from another starting point: a
seed that reshuffled the whole order would move an open loop's tail
latency by 10-25% between seeds at 0.8 of the knee (a simulation of the
fitted service times over twelve seeds), more than a change worth
seeing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Invocation:
    index: int
    due: Optional[float]  # seconds after the window opens (open loop); None: closed
    prompts: List[np.ndarray]  # token ids of each row, unpadded
    max_new: int

    @property
    def batch(self) -> int:
        return len(self.prompts)

    @property
    def padded_len(self) -> int:
        return max(len(p) for p in self.prompts)

    @property
    def prompt_tokens(self) -> int:
        return sum(len(p) for p in self.prompts)

    @property
    def shape(self) -> Tuple[Tuple[int, ...], int]:
        return tuple(len(p) for p in self.prompts), self.max_new


def load(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def _counts(n: int, weights: Sequence[float]) -> List[int]:
    """Exact shares of ``n`` by the largest remainder."""
    w = np.asarray(weights, np.float64) / sum(weights)
    raw = n * w
    out = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - out), kind="stable")[: n - out.sum()]:
        out[i] += 1
    return out.tolist()


def _exact(spec: Dict, n: int) -> List[int]:
    values = spec["values"]
    weights = spec.get("weights", [1.0] * len(values))
    out: List[int] = []
    for v, c in zip(values, _counts(n, weights)):
        out += [int(v)] * c
    return out


def _quantile_lengths(spec: Dict, n: int) -> List[int]:
    lo, hi = spec["loguniform"]
    u = (np.arange(n) + 0.5) / n
    return [int(round(x)) for x in np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))]


def shapes(mix: Dict, n: int) -> List[Tuple[Tuple[int, ...], int]]:
    """The fixed multiset of ``n`` invocation shapes (prompt lengths of each
    row, new tokens), the same for every seed."""
    rng = np.random.default_rng(mix["shape_seed"])
    batches = _exact(mix["batch"], n)
    news = _exact(mix["max_new_tokens"], n)
    rng.shuffle(batches)
    rng.shuffle(news)
    lengths = _quantile_lengths(mix["prompt_tokens"], sum(batches))
    rng.shuffle(lengths)
    out, at = [], 0
    for b, m in zip(batches, news):
        out.append((tuple(lengths[at:at + b]), m))
        at += b
    return out


def _cost(mix: Dict, shape) -> float:
    lens, m = shape
    w = mix["stratify_by"]
    return w["prefill_tokens"] * len(lens) * max(lens) + w["decode_steps"] * m


def balanced_order(costs: Sequence[float], block: int, rng: np.random.Generator) -> List[int]:
    """A permutation of ``range(len(costs))`` in blocks of ``block``: the
    items sorted by cost are cut into ``block`` strata, each shuffled, and
    block j takes the j-th item of every stratum, in shuffled order."""
    ranked = np.argsort(np.asarray(costs), kind="stable")
    strata = [list(s) for s in np.array_split(ranked, min(block, len(ranked)))]
    for s in strata:
        rng.shuffle(s)
    order: List[int] = []
    for j in range(max(len(s) for s in strata)):
        blk = [s[j] for s in strata if j < len(s)]
        rng.shuffle(blk)
        order += [int(i) for i in blk]
    return order


def open_loop_count(rate: float, seconds: float) -> int:
    return max(1, int(round(rate * seconds)))


def _gaps(n: int, seconds: float) -> np.ndarray:
    """Quantiles of the exponential distribution, scaled to sum to ``seconds``."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    return g * (seconds / g.sum())


def generate(mix: Dict, seed: int, vocab: int, *, rate: Optional[float] = None,
             seconds: Optional[float] = None) -> List[Invocation]:
    """The run's invocations in the order they are sent. Open loop: every
    invocation due in ``[0, seconds)`` at ``rate`` per second (``rate x
    seconds`` of them); closed loop: the mix's ``documents``, replayed in
    order by the caller."""
    if mix["loop"] == "open":
        n = open_loop_count(rate, seconds)
    elif mix["loop"] == "closed":
        n = mix["documents"]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    fixed = shapes(mix, n)
    cycle = np.random.default_rng([mix["shape_seed"], 2])
    order = balanced_order([_cost(mix, s) for s in fixed], mix["block"], cycle)
    dues: List[Optional[float]] = [None] * n
    gaps = None
    if mix["loop"] == "open":
        g = _gaps(n, seconds)
        gaps = g[balanced_order(g, mix["block"], cycle)]
    turn = int(np.random.default_rng([seed, 2]).integers(n))
    order = order[turn:] + order[:turn]
    if gaps is not None:
        gaps = np.roll(gaps, -turn)
        dues = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]).tolist()
    tok = np.random.default_rng([seed, 1])
    out = []
    for i, k in enumerate(order):
        lens, m = fixed[k]
        prompts = [tok.integers(1, vocab, size=L, dtype=np.int64) for L in lens]
        out.append(Invocation(i, dues[i], prompts, m))
    return out

