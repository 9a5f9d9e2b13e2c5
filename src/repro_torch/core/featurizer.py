"""Input Featurizer (paper §4.3.1, Appendix A Table 2).

The port's own copy of ``repro/core/featurizer.py`` (pure NumPy).

Extracts descriptive, performance-relevant features per input TYPE (not
content understanding — "our models learn the descriptive features of
inputs that may affect performance"). Feature lists mirror Table 2:

  image : width, height, channels, x-dpi, y-dpi, file size
  matrix: rows, cols, density
  video : width, height, duration, bitrate, avg frame rate, encoding
  csv   : rows, cols, file size
  json  : outer length, file size
  audio : channels, sample rate, duration, bit rate, is_flac
  request (TPU adaptation): prompt tokens, batch, max new tokens,
          image tiles, audio seconds — the serving-side analogue.

Inputs arrive as metadata dicts (the datastore path of the paper — the
featurization happened in the background when the object was persisted;
``Featurizer.extract`` is the lookup). Unknown types fall back to the
invocation payload, exactly as in §6.

Features are standardized online (running mean/var per function) before
reaching the linear CSOAA agents — raw file sizes span 6 orders of
magnitude and would swamp a linear model otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch import tracing

_ENCODINGS = ["mp4", "mpeg4", "h264", "h265", "vp9", "av1", "webm"]

FEATURE_SCHEMAS: Dict[str, List[str]] = {
    "image": ["width", "height", "channels", "dpi_x", "dpi_y", "file_size"],
    "matrix": ["rows", "cols", "density"],
    "video": ["width", "height", "duration", "bitrate", "fps", "encoding"],
    "csv": ["rows", "cols", "file_size"],
    "json": ["outer_len", "file_size"],
    "audio": ["channels", "sample_rate", "duration", "bitrate", "is_flac"],
    "string": ["length"],
    "batch_of_strings": ["count", "total_length"],
    "url": ["length"],
    "file": ["file_size"],
    "training_set": ["file_size", "rows", "cols"],
    "request": [
        "prompt_tokens",
        "batch",
        "max_new_tokens",
        "image_tiles",
        "audio_seconds",
    ],
    "payload": ["payload"],
}


def _encode_enum(value, table: Sequence[str]) -> float:
    try:
        return float(table.index(str(value).lower()) + 1)
    except ValueError:
        return 0.0


@dataclasses.dataclass
class RunningStats:
    """Online per-dimension standardization (Welford)."""

    n: int
    mean: np.ndarray
    m2: np.ndarray

    @classmethod
    def create(cls, dim: int) -> "RunningStats":
        return cls(0, np.zeros(dim), np.zeros(dim))

    def update(self, x: np.ndarray) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    def normalize(self, x: np.ndarray) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(x)
        std = np.sqrt(self.m2 / (self.n - 1)) + 1e-6
        return (x - self.mean) / std


class Featurizer:
    """Per-input-type feature extraction + online standardization.

    One instance serves the whole platform; standardization state is kept
    per function (the agents are per function, §4.2)."""

    def __init__(self):
        self._stats: Dict[str, RunningStats] = {}
        # Background-extracted object features (the metadata-store path).
        self._object_cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------ raw
    def raw_features(self, input_type: str, meta: Dict) -> np.ndarray:
        schema = FEATURE_SCHEMAS.get(input_type)
        if schema is None:
            schema = FEATURE_SCHEMAS["payload"]
            meta = {"payload": float(meta.get("payload", 0.0))}
        vals = []
        for name in schema:
            v = meta.get(name, 0.0)
            if name == "encoding":
                v = _encode_enum(v, _ENCODINGS)
            elif name == "is_flac":
                v = 1.0 if v else 0.0
            vals.append(float(v))
        # log1p compresses the dynamic range of size-like features.
        out = np.asarray(vals, dtype=np.float64)
        sizelike = [i for i, nm in enumerate(schema)
                    if nm in ("file_size", "rows", "cols", "length",
                              "total_length", "bitrate", "prompt_tokens")]
        for i in sizelike:
            out[i] = math.log1p(max(out[i], 0.0))
        return out

    # ------------------------------------------------- background path
    def persist_object(self, object_id: str, input_type: str, meta: Dict) -> None:
        """Called when a data object lands in the datastore — feature
        extraction off the critical path (§4.3.1)."""
        self._object_cache[object_id] = self.raw_features(input_type, meta)

    def has_object(self, object_id: str) -> bool:
        return object_id in self._object_cache

    # ------------------------------------------------------- invocation
    def extract(self, function: str, input_type: str, meta: Dict,
                object_id: str = "") -> np.ndarray:
        """Features for one invocation, standardized per function.

        Cached object features are used when available (no critical-path
        cost); otherwise extraction happens inline (storage-trigger path).
        Timed by the span ``allocator.featurize``.
        """
        with tracing.span("allocator.featurize"):
            if object_id and object_id in self._object_cache:
                raw = self._object_cache[object_id]
            else:
                raw = self.raw_features(input_type, meta)
            key = function
            stats = self._stats.get(key)
            if stats is None or stats.mean.shape[0] != raw.shape[0]:
                stats = RunningStats.create(raw.shape[0])
                self._stats[key] = stats
            stats.update(raw)
            return stats.normalize(raw).astype(np.float32)

    def feature_dim(self, input_type: str) -> int:
        return len(FEATURE_SCHEMAS.get(input_type, FEATURE_SCHEMAS["payload"]))
