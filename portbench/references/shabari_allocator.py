"""Plain NumPy reference of Shabari's allocator (paper section 4), for
one function's ``request`` inputs, replayed one invocation at a time.

Featurizer: the five request features (prompt tokens, batch, max new
tokens, image tiles, audio seconds), ``log1p`` of the prompt tokens,
standardised by a per-function running mean and variance (Welford, in
float64; zeros while fewer than two inputs were seen; std + 1e-6), then
taken to float32.

Agents: one cost-sensitive one-against-all classifier per resource
(Vowpal Wabbit's csoaa): per class a linear regressor over the features
and a bias predicts the class's cost, the cheapest class wins (ties to
the first). Each feedback takes one least-squares step per class with
AdaGrad rates (lr 0.5), in float32, the dot product summed left to right
with one rounding per operation. A resource is predicted once its agent
has seen ``confidence`` feedbacks; before that the default is served.

Costs: 1 at the target class, growing by 3 a class below it (memory 6)
and 1 a class above. vCPU target (the absolute variant): SLO met, the
smaller of the allocated and used classes less one per 1.5 s of slack;
missed with utilisation under 0.9, the used class; missed otherwise, the
used class plus one plus one per 0.5 s of violation. Memory target: the
class of the memory used (128 MB classes).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

F32 = np.float32


class Featurizer:
    def __init__(self, dim: int = 5):
        self.n = 0
        self.mean = np.zeros(dim)
        self.m2 = np.zeros(dim)

    def __call__(self, prompt_tokens: int, batch: int, max_new: int) -> np.ndarray:
        raw = np.array([math.log1p(max(float(prompt_tokens), 0.0)), float(batch),
                        float(max_new), 0.0, 0.0], np.float64)
        self.n += 1
        delta = raw - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (raw - self.mean)
        if self.n < 2:
            return np.zeros(5, F32)
        std = np.sqrt(self.m2 / (self.n - 1)) + 1e-6
        return ((raw - self.mean) / std).astype(F32)


class Agent:
    def __init__(self, n_classes: int, dim: int, lr: float = 0.5):
        self.w = np.zeros((n_classes, dim + 1), F32)
        self.g2 = np.zeros_like(self.w)
        self.lr = F32(lr)
        self.updates = 0

    @staticmethod
    def _matvec(w: np.ndarray, xb: np.ndarray) -> np.ndarray:
        acc = w[:, 0] * xb[0]
        for i in range(1, w.shape[1]):
            acc = acc + w[:, i] * xb[i]
        return acc

    def predict(self, x: np.ndarray) -> int:
        return int(np.argmin(self._matvec(self.w, np.append(x, F32(1.0)))))

    def update(self, x: np.ndarray, costs: np.ndarray) -> None:
        xb = np.append(x, F32(1.0))
        err = self._matvec(self.w, xb) - costs.astype(F32)
        grad = err[:, None] * xb[None, :]
        self.g2 = self.g2 + grad * grad
        step = self.lr * grad / (np.sqrt(self.g2) + F32(1e-6))
        self.w = self.w - step
        self.updates += 1


def _linear_costs(n: int, target: int, under: float) -> np.ndarray:
    idx = np.arange(n, dtype=np.float64)
    return 1.0 + under * np.maximum(target - idx, 0.0) + np.maximum(idx - target, 0.0)


def _clamp(i: int, n: int) -> int:
    return max(0, min(n - 1, i))


def vcpu_costs(exec_s, slo_s, alloc, used, n) -> np.ndarray:
    cur = _clamp(alloc - 1, n)
    usedc = _clamp(int(math.ceil(used)) - 1, n)
    if exec_s <= slo_s:
        target = min(cur, usedc) - int((slo_s - exec_s) / 1.5)
    elif used / max(alloc, 1) < 0.9:
        target = usedc
    else:
        target = usedc + 1 + int((exec_s - slo_s) / 0.5)
    return _linear_costs(n, _clamp(target, n), 3.0)


def mem_costs(used_mb, n, class_mb) -> np.ndarray:
    return _linear_costs(n, _clamp(int(math.ceil(used_mb / class_mb)) - 1, n), 6.0)


def usage(prompt_tokens: int, vcpus: int) -> Tuple[float, float]:
    """The synthetic usage the served loop reports (vCPUs used, MB used),
    by ``launch/serve.py``'s rule over the invocation's prompt tokens."""
    return float(min(vcpus, max(prompt_tokens // 16, 1))), 64 + 0.5 * prompt_tokens


def replay(invocations: Sequence[Dict], *, vcpu_classes: int, mem_classes: int,
           vcpu_confidence: int, mem_confidence: int, default_vcpus: int,
           default_mem_class: int, class_mb: int) -> List[Tuple[int, int]]:
    """The (vCPUs, MB) the allocator serves to each invocation in order.
    Each invocation gives its features (``padded_len``, ``batch``,
    ``max_new``), the measured ``exec_s``, its ``slo_s`` and the
    ``prompt_tokens`` that the usage rule reads."""
    feat = Featurizer()
    vcpu = Agent(vcpu_classes, 5)
    mem = Agent(mem_classes, 5)
    out = []
    for inv in invocations:
        x = feat(inv["padded_len"], inv["batch"], inv["max_new"])
        v = vcpu.predict(x) + 1 if vcpu.updates >= vcpu_confidence else default_vcpus
        m = ((mem.predict(x) + 1) * class_mb if mem.updates >= mem_confidence
             else default_mem_class * class_mb)
        out.append((v, m))
        used_v, used_mb = usage(inv["prompt_tokens"], v)
        vcpu.update(x, vcpu_costs(inv["exec_s"], inv["slo_s"], v, used_v, vcpu_classes))
        mem.update(x, mem_costs(used_mb, mem_classes, class_mb))
    return out
