"""Alternative ML formulations for the §4.2 study (Figure 6).

The paper empirically compares three ways to structure the online
agents before settling on one-model-per-function:

* ``per-function``   — one (vCPU, mem) agent pair per function (chosen);
* ``one-hot``        — a single agent across ALL functions; feature
  vectors are concatenated per-function blocks with the inactive
  functions zeroed (the model cannot specialize — its allocation pins
  at 9-13 vCPUs, wasting 5x more at p90);
* ``per-input-type`` — one agent per input TYPE (image, video, ...);
  functions sharing a type share a model, so the single-threaded
  function that completes first drags down the multi-threaded one
  (mobilenet vs imageprocess in the paper).

These reuse ``ResourceAllocator`` unchanged — only the agent KEY and the
feature layout differ, which is exactly the paper's point.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.allocator import Allocation, ResourceAllocator
from repro_torch.core.cost_functions import Observation


class FormulationAllocator:
    """Wraps ResourceAllocator with a configurable agent-key/feature map."""

    def __init__(self, mode: str, functions: Sequence[str],
                 feature_dims: Dict[str, int], input_type_of: Dict[str, str],
                 **alloc_kwargs):
        assert mode in ("per-function", "one-hot", "per-input-type")
        self.mode = mode
        self.functions = list(functions)
        self.feature_dims = feature_dims
        self.input_type_of = input_type_of
        self.inner = ResourceAllocator(**alloc_kwargs)
        self._offsets: Dict[str, int] = {}
        off = 0
        for fn in self.functions:
            self._offsets[fn] = off
            off += feature_dims[fn]
        self._total_dim = off

    def _key_and_features(self, function: str, x: np.ndarray):
        if self.mode == "per-function":
            return function, x
        if self.mode == "per-input-type":
            return self.input_type_of[function], x
        # one-hot: one global agent, block-concatenated features
        big = np.zeros(self._total_dim, np.float32)
        o = self._offsets[function]
        big[o : o + len(x)] = x
        return "__all__", big

    def allocate(self, function: str, x: np.ndarray,
                 input_size_mb: float = 0.0) -> Allocation:
        key, feats = self._key_and_features(function, x)
        return self.inner.allocate(key, feats, input_size_mb)

    def allocate_batch(self, items):
        """Microbatch pass-through: shared-agent modes may map several
        items onto the same key — predictions don't mutate state, so
        duplicates in one batch are safe."""
        mapped = [self._key_and_features(fn, x) for fn, x, _ in items]
        return self.inner.allocate_batch(
            [(key, feats, items[i][2]) for i, (key, feats) in enumerate(mapped)]
        )

    def feedback(self, function: str, x: np.ndarray, obs: Observation) -> None:
        key, feats = self._key_and_features(function, x)
        self.inner.feedback(key, feats, obs)

    def flush(self) -> None:
        self.inner.flush()
