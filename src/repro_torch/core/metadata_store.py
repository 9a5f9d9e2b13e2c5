"""In-memory metadata store (paper Fig. 5): object features + telemetry.

The store sits beside the Resource Allocator; the worker daemons push
per-invocation performance + utilization records here over gRPC in the
paper (a method call in our runtime). The allocator drains pending
records to update its agents off the critical path.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_functions import Observation


@dataclasses.dataclass(slots=True)
class InvocationRecord:
    function: str
    invocation_id: int
    features: np.ndarray
    observation: Observation
    finish_time: float


class MetadataStore:
    def __init__(self, history_limit: int = 100_000):
        self._pending: Deque[InvocationRecord] = collections.deque()
        self._history: Deque[InvocationRecord] = collections.deque(maxlen=history_limit)
        self._object_meta: Dict[str, Tuple[str, dict]] = {}

    # ------------------------------------------------ object metadata
    def put_object(self, object_id: str, input_type: str, meta: dict) -> None:
        self._object_meta[object_id] = (input_type, meta)

    def get_object(self, object_id: str) -> Optional[Tuple[str, dict]]:
        return self._object_meta.get(object_id)

    # ------------------------------------------------ telemetry
    def push(self, rec: InvocationRecord) -> None:
        self._pending.append(rec)
        self._history.append(rec)

    def drain(self) -> List[InvocationRecord]:
        out = list(self._pending)
        self._pending.clear()
        return out

    def history(self, function: Optional[str] = None) -> List[InvocationRecord]:
        if function is None:
            return list(self._history)
        return [r for r in self._history if r.function == function]
