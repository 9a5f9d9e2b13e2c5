"""Performance/utilization profiles for the paper's 12 functions (Table 1).

Each profile supplies what the 17-node testbed supplies in the paper:
execution time, vCPU utilization, and memory footprint for a given
(input, vCPU allocation) — parameterized to reproduce the §2
measurement-study observations:

* positive but NON-linear size→time relationships (§2.1, Figure 2);
* input properties beyond size matter: ``videoprocess`` parallelism and
  memory are driven by RESOLUTION — same-size videos differ ~70% in
  vCPUs used (Figure 3);
* bounded parallelism: imageprocess/sentiment/encrypt/speech2text/qr are
  single-threaded; matmult/linpack/compress/lrtrain/resnet scale then
  saturate (§2.2, Figure 4);
* decoupled intensities: videoprocess/matmult/linpack/lrtrain are
  compute-heavy with low memory use; sentiment is memory-bound at
  1 vCPU (§2.3);
* larger inputs of multi-threaded functions run noisier — ``compress``
  shows ~50% execution-time variability at 2 GB (Figure 2c).

The model: exec = t0 + serial(meta) + parallel(meta)/min(v, par(meta)),
times a contention factor supplied by the simulator, times lognormal
noise that grows with input size for multi-threaded functions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FunctionProfile:
    name: str
    input_type: str
    # work components (seconds of single-core time)
    t0: float  # fixed startup/serial floor
    serial: Callable[[Dict], float]
    parallel: Callable[[Dict], float]
    max_parallelism: Callable[[Dict], float]
    mem_mb: Callable[[Dict], float]
    noise_base: float = 0.03  # lognormal sigma at the smallest inputs
    noise_size_coef: float = 0.0  # extra sigma per unit of size_scale(meta)
    size_scale: Callable[[Dict], float] = lambda m: 0.0

    def exec_time(self, meta: Dict, vcpus: int, rng: np.random.Generator,
                  contention: float = 1.0) -> float:
        par = max(1.0, min(float(vcpus), self.max_parallelism(meta)))
        t = self.t0 + self.serial(meta) + self.parallel(meta) / par
        sigma = self.noise_base + self.noise_size_coef * self.size_scale(meta)
        t *= float(rng.lognormal(mean=0.0, sigma=sigma))
        return t * max(contention, 1.0)

    def vcpus_used(self, meta: Dict, vcpus: int) -> float:
        """Peak parallel occupancy given the allocation."""
        par = max(1.0, min(float(vcpus), self.max_parallelism(meta)))
        ser = self.t0 + self.serial(meta)
        pw = self.parallel(meta)
        if pw <= 0:
            return 1.0
        # time-weighted peak: during the parallel phase, par cores are busy
        return min(float(vcpus), par)

    def exec_and_demand(self, meta: Dict, vcpus: int,
                        rng: np.random.Generator) -> Tuple[float, float]:
        """Fused ``(exec_time(contention=1), vcpus_used)`` — one pass
        over the per-input lambdas instead of two (the simulator's hot
        start path calls both for every invocation). Identical values
        and the identical single rng draw."""
        v = float(vcpus)
        par = max(1.0, min(v, self.max_parallelism(meta)))
        pw = self.parallel(meta)
        t = self.t0 + self.serial(meta) + pw / par
        sigma = self.noise_base + self.noise_size_coef * self.size_scale(meta)
        t *= float(rng.lognormal(mean=0.0, sigma=sigma))
        return t, (1.0 if pw <= 0 else min(v, par))

    def mem_used_mb(self, meta: Dict) -> float:
        return self.mem_mb(meta)


def _mb(x: float) -> float:
    return x / 1e6


_BASE_CACHE: Dict[str, str] = {}


def base_function(fn: str) -> str:
    """Strip a clone suffix (``matmult::3`` -> ``matmult``).

    Scenario generators (cold-storm) clone the 12 paper functions into
    many independently-named aliases; everything keyed on the function's
    BEHAVIOR (profile shape, network-fed set, input-size model) must
    look through the alias. Memoized — the hot loop asks per event and
    the alias universe is small."""
    base = _BASE_CACHE.get(fn)
    if base is None:
        base = _BASE_CACHE[fn] = fn.split("::", 1)[0]
    return base


# ---------------------------------------------------------------------------
# The 12 functions
# ---------------------------------------------------------------------------


def build_profiles() -> Dict[str, FunctionProfile]:
    P: Dict[str, FunctionProfile] = {}

    # matmult: n in 500..80000; beyond ~10k the matrices are sparse
    # (density shrinks), capping the dense working set at ~2.5 GB.
    P["matmult"] = FunctionProfile(
        name="matmult", input_type="matrix", t0=0.15,
        serial=lambda m: 2e-9 * m["rows"] * m["cols"],
        parallel=lambda m: 5.2e-11 * m["rows"] ** 1.5 * m["cols"] ** 1.5
        * max(m.get("density", 1.0), 0.05),
        max_parallelism=lambda m: min(32.0, 4.0 + m["rows"] / 2500.0),
        mem_mb=lambda m: 60.0
        + 3 * 8e-6 * min(m["rows"], 10_000.0) * min(m["cols"], 10_000.0),
        noise_base=0.04, noise_size_coef=0.03,
        size_scale=lambda m: m["rows"] / 80000.0,
    )

    # linpack: n in 500..8000 (solve, n^3)
    P["linpack"] = FunctionProfile(
        name="linpack", input_type="matrix", t0=0.12,
        serial=lambda m: 1e-8 * m["rows"] * m["cols"] ** 0.5,
        parallel=lambda m: 1.8e-9 * m["rows"] ** 3 / 1e2,
        max_parallelism=lambda m: min(24.0, 2.0 + m["rows"] / 600.0),
        mem_mb=lambda m: 50.0 + 2 * 8e-6 * m["rows"] * m["cols"],
        noise_base=0.05, noise_size_coef=0.02,
        size_scale=lambda m: m["rows"] / 8000.0,
    )

    # imageprocess: single-threaded resize/filter. Two regimes: beyond
    # ~2 MP the working set spills cache and the per-pixel cost grows —
    # the non-linear size->time relation of Figure 2 (contra Cypress's
    # linear assumption).
    P["imageprocess"] = FunctionProfile(
        name="imageprocess", input_type="image", t0=0.08,
        serial=lambda m: 6.6e-7 * (m["width"] * m["height"]) ** 0.92
        * (1.0 + m["width"] * m["height"] / 2.5e6),
        parallel=lambda m: 0.0,
        max_parallelism=lambda m: 1.0,
        mem_mb=lambda m: 40.0 + 4e-6 * m["width"] * m["height"] * m["channels"],
        noise_base=0.04,
    )

    # videoprocess: parallelism and memory driven by RESOLUTION, not size.
    # high-res (>=1280x720): heavy frames -> fewer decode threads useful,
    # bigger frame buffers; low-res: many slices in flight -> up to 48 cores.
    P["videoprocess"] = FunctionProfile(
        name="videoprocess", input_type="video", t0=0.3,
        serial=lambda m: 0.04 * m["duration"],
        parallel=lambda m: 1.9e-6 * m["bitrate"] * m["duration"] / 8.0,
        # scalar min/max == np.clip here (clip is min(hi, max(x, lo)))
        # without the per-call ufunc dispatch on a python float
        max_parallelism=lambda m: min(
            48.0, max(56.0 * 9.2e5 / (m["width"] * m["height"]), 6.0)
        ),
        mem_mb=lambda m: 90.0 + 9e-6 * m["width"] * m["height"] * 24
        + 2e-7 * m["bitrate"],
        noise_base=0.05, noise_size_coef=0.04,
        size_scale=lambda m: m["duration"] / 120.0,
    )

    # encrypt: single-threaded, linear in payload length
    P["encrypt"] = FunctionProfile(
        name="encrypt", input_type="string", t0=0.05,
        serial=lambda m: 1.2e-4 * m["length"],
        parallel=lambda m: 0.0,
        max_parallelism=lambda m: 1.0,
        mem_mb=lambda m: 30.0 + 1e-3 * m["length"],
        noise_base=0.03,
    )

    # mobilenet inference: mild parallelism (intra-op), const + pixels
    P["mobilenet"] = FunctionProfile(
        name="mobilenet", input_type="image", t0=0.35,
        serial=lambda m: 0.12 + 1.5e-8 * m["width"] * m["height"],
        parallel=lambda m: 4.6e-6 * (m["width"] * m["height"]) ** 0.95,
        max_parallelism=lambda m: 4.0,
        mem_mb=lambda m: 260.0 + 6e-6 * m["width"] * m["height"],
        noise_base=0.05,
    )

    # sentiment: memory-bound, single-threaded (embedding tables)
    P["sentiment"] = FunctionProfile(
        name="sentiment", input_type="batch_of_strings", t0=0.25,
        serial=lambda m: 7e-3 * m["count"] + 2.4e-6 * m["total_length"],
        parallel=lambda m: 0.0,
        max_parallelism=lambda m: 1.0,
        mem_mb=lambda m: 800.0 + 0.6 * m["count"],
        noise_base=0.04,
    )

    # speech2text: single-threaded decode, linear in duration
    P["speech2text"] = FunctionProfile(
        name="speech2text", input_type="audio", t0=0.5,
        serial=lambda m: 0.9 * m["duration"],
        parallel=lambda m: 0.0,
        max_parallelism=lambda m: 1.0,
        mem_mb=lambda m: 350.0 + 1.6 * m["duration"],
        noise_base=0.05,
    )

    # qr: trivial single-threaded
    P["qr"] = FunctionProfile(
        name="qr", input_type="url", t0=0.04,
        serial=lambda m: 2.5e-4 * m["length"],
        parallel=lambda m: 0.0,
        max_parallelism=lambda m: 1.0,
        mem_mb=lambda m: 25.0 + 0.05 * m["length"],
        noise_base=0.03,
    )

    # lrtrain: data-parallel epochs; work ~ rows*cols
    P["lrtrain"] = FunctionProfile(
        name="lrtrain", input_type="training_set", t0=0.4,
        serial=lambda m: 1.2e-8 * m["rows"] * m["cols"],
        parallel=lambda m: 2.8e-6 * m["rows"] * m["cols"],
        max_parallelism=lambda m: min(24.0, 2.0 + m["rows"] / 8e4),
        mem_mb=lambda m: 150.0 + 16e-6 * m["rows"] * m["cols"],
        noise_base=0.05, noise_size_coef=0.03,
        size_scale=lambda m: m["rows"] / 1e6,
    )

    # compress: multi-threaded (zstd-like), variability grows with size
    P["compress"] = FunctionProfile(
        name="compress", input_type="file", t0=0.2,
        serial=lambda m: 2e-9 * m["file_size"],
        parallel=lambda m: 6.5e-8 * m["file_size"],
        max_parallelism=lambda m: min(
            20.0, 2.0 + _mb(m["file_size"]) / 64.0
        ),
        mem_mb=lambda m: 120.0 + 0.25 * _mb(m["file_size"]),
        noise_base=0.05, noise_size_coef=0.22,
        size_scale=lambda m: _mb(m["file_size"]) / 2000.0,
    )

    # resnet-50 inference: saturating parallel gains (Figure 4b)
    P["resnet50"] = FunctionProfile(
        name="resnet50", input_type="image", t0=0.4,
        serial=lambda m: 0.18 + 2e-8 * m["width"] * m["height"],
        parallel=lambda m: 1.8e-5 * (m["width"] * m["height"]) ** 0.92,
        max_parallelism=lambda m: min(
            12.0, 3.0 + m["width"] * m["height"] / 1.2e6
        ),
        mem_mb=lambda m: 700.0 + 8e-6 * m["width"] * m["height"],
        noise_base=0.05,
    )

    return P


# ---------------------------------------------------------------------------
# Input pools (Table 1 size ranges; videoprocess gets the two §2.1 sets)
# ---------------------------------------------------------------------------


def build_input_pool(seed: int = 0) -> Dict[str, List[Dict]]:
    rng = np.random.default_rng(seed)
    pool: Dict[str, List[Dict]] = {}

    def sizes(lo, hi, n, log=True):
        if log:
            return np.exp(np.linspace(math.log(lo), math.log(hi), n))
        return np.linspace(lo, hi, n)

    pool["matmult"] = [
        {"rows": float(n), "cols": float(n), "density": float(rng.uniform(0.3, 1.0))}
        for n in sizes(500, 80000, 9)
    ]
    pool["linpack"] = [
        {"rows": float(n), "cols": float(n), "density": 1.0}
        for n in sizes(500, 8000, 11)
    ]

    def image_inputs(n, lo=12e3, hi=4.6e6):
        out = []
        for fs in sizes(lo, hi, n):
            # file size -> resolution (jpeg ~ 0.5 byte/pixel), 3-4 channels
            pixels = fs * 2.2
            ar = rng.uniform(0.6, 1.8)
            w = math.sqrt(pixels * ar)
            out.append({
                "width": float(w), "height": float(pixels / w),
                "channels": float(rng.choice([1, 3, 3, 4])),
                "dpi_x": 72.0, "dpi_y": 72.0, "file_size": float(fs),
            })
        return out

    pool["imageprocess"] = image_inputs(14)
    pool["mobilenet"] = image_inputs(14)
    pool["resnet50"] = image_inputs(9, lo=184e3)

    # videoprocess: set-1 (varying resolution) + set-2 (constant 1280x720)
    vids = []
    for fs in sizes(2.2e6, 6.1e6, 3):
        for (w, h) in ((640, 360), (1280, 720), (1920, 1080)):
            dur = fs * 8.0 / (w * h * 0.07)  # duration from size & res
            vids.append({
                "width": float(w), "height": float(h),
                "duration": float(np.clip(dur, 4, 180)),
                "bitrate": float(fs * 8.0 / np.clip(dur, 4, 180)),
                "fps": 30.0, "encoding": "h264", "file_size": float(fs),
            })
    pool["videoprocess"] = vids[:5] + [
        {"width": 1280.0, "height": 720.0,
         "duration": float(np.clip(fs * 8 / (1280 * 720 * 0.07), 4, 180)),
         "bitrate": float(1280 * 720 * 0.07),
         "fps": 30.0, "encoding": "mp4", "file_size": float(fs)}
        for fs in sizes(2.2e6, 6.1e6, 3)
    ]

    pool["encrypt"] = [{"length": float(n)} for n in sizes(500, 50000, 7)]
    pool["sentiment"] = [
        {"count": float(n), "total_length": float(n) * 80.0}
        for n in sizes(50, 3000, 12)
    ]
    pool["speech2text"] = [
        {"channels": 1.0, "sample_rate": 16000.0,
         "duration": float(fs / 32000.0),  # 16 kHz x 2 B/sample
         "bitrate": 256000.0, "is_flac": bool(rng.random() < 0.3),
         "file_size": float(fs)}
        for fs in sizes(48e3, 12e6, 8)
    ]
    pool["qr"] = [{"length": float(n)} for n in sizes(25, 480, 11, log=False)]
    pool["lrtrain"] = [
        {"file_size": float(fs), "rows": float(fs / 100.0), "cols": 25.0}
        for fs in sizes(10e6, 100e6, 4)
    ]
    pool["compress"] = [{"file_size": float(fs)} for fs in sizes(64e6, 2e9, 7)]
    return pool


def input_size_mb(fn: str, meta: Dict) -> float:
    fn = base_function(fn)
    fs = meta.get("file_size")
    if fs is not None:
        return fs / 1e6
    if fn in ("matmult", "linpack"):
        return 8e-6 * meta["rows"] * meta["cols"]
    if fn == "sentiment":
        return meta["total_length"] / 1e6
    return 0.001
