"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repository root, keyed by a
hash of the source and the flags, at first use. The library exposes a
plain C function, ``<name>_launch``, that launches the kernel on the
stream it is given and returns ``cudaGetLastError()`` (and may expose
plain C helpers beside it). No PyTorch header
is compiled, so a build takes seconds. Nothing here runs at import time:
the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "moe_gmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes.CFUNCTYPE] = {}
# nvcc's output (the ptxas register / shared-memory report) per kernel
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Sequence[str] = KERNELS) -> None:
    """Compile every kernel whose library is missing: one nvcc process per
    source, all started together. Raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        build_logs[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{build_logs[n]}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str, argtypes: Sequence, symbol: Optional[str] = None) -> ctypes.CFUNCTYPE:
    """``symbol`` (by default ``<name>_launch``) from the kernel's library,
    building it first if needed; every argument type is declared so ctypes
    never truncates a pointer."""
    symbol = symbol or f"{name}_launch"
    fn = _fns.get(symbol)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn
