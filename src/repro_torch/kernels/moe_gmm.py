"""MoE grouped matmuls: the wrappers of ``csrc/moe_gmm.cu``.

Replaces the TPU kernel ``src/repro/kernels/moe_gmm.py:47`` (``moe_gmm``;
its plain version is :func:`repro_torch.kernels.ref.moe_gmm_ref`):
``out[e] = buf[e] @ w[e]`` for (E, C, D) x (E, D, F) -> (E, C, F),
accumulated in float32 and written in buf's dtype. The wrapper checks
what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused. It never falls
back to the plain version: :mod:`repro_torch.kernels.ops` routes CPU
tensors and ``use_kernels=False`` there before this module is reached.

``buf`` may be a strided view (in the model it is ``[:, :C]`` of the
(E, C+1, D) scatter buffer): the kernel takes its expert and row
strides and needs only its last axis contiguous. ``w`` is read in place
and must be contiguous, so a weight is never copied.

The kernel splits D into S slices, so that a block's share of buf fits
its shared memory and the blocks fill the card; the library's
``moe_gmm_slices`` picks S, and the wrapper allocates the fp32 workspace
the slices' sums go through, with the per-slice live flags after it.

A slice of an expert whose staged rows are all zero (an expert no token
routes to) reads no weight: its product is exactly 0. bf16 runs on the
tensor cores, float32 on the CUDA cores (``csrc/moe_gmm.cu``).

:func:`moe_gmm_grouped` is the ragged product of the dropless dispatch
(its plain version :func:`repro_torch.kernels.ref.moe_gmm_grouped_ref`):
x (R, D) holds rows sorted by expert, expert e's rows
``offsets[e]:offsets[e+1]`` (int32 on the device, never read here), and
``out[r] = x[r] @ w[e]``, (R, F). bf16 runs the warpgroup-MMA body,
which reuses each weight tile across 128 rows of an expert (it takes D
and F in multiples of 8), float32 the CUDA-core body. The grid depends
on the shapes alone, so a call records into a CUDA graph, and an expert
with no rows reads no weight. A decode step's few rows take
:func:`moe_gmm`'s decode body instead (``models/moe.py``). Launches
count as ``kernels.launches.moe_gmm_grouped``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (
    [_PTR, _I64, _I64]             # buf, its expert and row strides
    + [_PTR, _PTR, _PTR]           # w, out, fp32 workspace (or NULL)
    + [_INT] * 6                   # E, C, D, F, S, is_bf16
    + [_PTR]                       # stream
)
DTYPES = (torch.float32, torch.bfloat16)
_SLICES_ARGTYPES = [_INT] * 5 + [_PTR, _INT]  # E, C, D, F, is_bf16, w, SMs
MAX_GRID = 65535  # the kernel's grid: E blocks deep
_GROUPED_ARGTYPES = (
    [_PTR] * 4                     # x, w, offsets, out
    + [_INT] * 5                   # R, E, D, F, is_bf16
    + [_PTR]                       # stream
)


def moe_gmm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    for name, t in (("buf", buf), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"moe_gmm: {name} is on {t.device}, not CUDA")
    if w.device != buf.device:
        raise ValueError(f"moe_gmm: buf is on {buf.device}, w on {w.device}")
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gmm: shapes buf {tuple(buf.shape)} w {tuple(w.shape)}")
    E, C, D = buf.shape
    F = w.shape[2]
    if w.shape[:2] != (E, D):
        raise ValueError(f"moe_gmm: shapes buf {tuple(buf.shape)} w {tuple(w.shape)}")
    if buf.dtype not in DTYPES or w.dtype != buf.dtype:
        raise ValueError(f"moe_gmm: dtypes buf {buf.dtype} w {w.dtype} not supported")
    if min(E, C, D, F) == 0 or E > MAX_GRID or max(C, D, F) >= 2 ** 30:
        raise ValueError(f"moe_gmm: sizes E={E} C={C} D={D} F={F} not supported")
    if buf.stride(2) != 1:
        raise ValueError("moe_gmm: buf needs a contiguous last axis")
    if not w.is_contiguous():
        raise ValueError("moe_gmm: w is not contiguous (a weight is never copied)")
    launch = _build.load("moe_gmm", _ARGTYPES)
    is_bf16 = int(buf.dtype == torch.bfloat16)
    sms = torch.cuda.get_device_properties(buf.device).multi_processor_count
    S = _build.load("moe_gmm", _SLICES_ARGTYPES, "moe_gmm_slices")(
        E, C, D, F, is_bf16, w.data_ptr(), sms)
    if S < 1:
        raise ValueError(f"moe_gmm: sizes E={E} C={C} D={D} F={F} exceed the kernel's grid")
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    # S * E * C * F fp32 sums, then S * E * ceil(C / 8) int32 live flags
    part = (torch.empty(S * E * (C * F + -(-C // 8)), dtype=torch.float32, device=buf.device)
            if S > 1 else None)
    with torch.cuda.device(buf.device):
        rc = launch(buf.data_ptr(), buf.stride(0), buf.stride(1), w.data_ptr(),
                    out.data_ptr(), None if part is None else part.data_ptr(),
                    E, C, D, F, S, is_bf16, torch.cuda.current_stream(buf.device).cuda_stream)
    if rc:
        raise RuntimeError(f"moe_gmm: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.moe_gmm")
    return out


def moe_gmm_grouped(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    for name, t in (("x", x), ("w", w), ("offsets", offsets)):
        if not t.is_cuda:
            raise ValueError(f"moe_gmm_grouped: {name} is on {t.device}, not CUDA")
        if t.device != x.device:
            raise ValueError(f"moe_gmm_grouped: x is on {x.device}, {name} on {t.device}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"moe_gmm_grouped: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    R, D = x.shape
    E, F = w.shape[0], w.shape[2]
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"moe_gmm_grouped: offsets {tuple(offsets.shape)} {offsets.dtype}, "
                         f"not ({E + 1},) int32")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"moe_gmm_grouped: dtypes x {x.dtype} w {w.dtype} not supported")
    if min(R, D, F) == 0 or E > MAX_GRID or max(R, D, F) >= 2 ** 30:
        raise ValueError(f"moe_gmm_grouped: sizes R={R} E={E} D={D} F={F} not supported")
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("moe_gmm_grouped: x and offsets must be contiguous")
    if not w.is_contiguous():
        raise ValueError("moe_gmm_grouped: w is not contiguous (a weight is never copied)")
    is_bf16 = int(x.dtype == torch.bfloat16)
    if is_bf16 and (D % 8 or F % 8 or (x.data_ptr() | w.data_ptr()) % 16):
        raise ValueError(f"moe_gmm_grouped: bf16 takes D={D} and F={F} in multiples of 8 "
                         "and 16-byte aligned x and w")
    launch = _build.load("moe_gmm", _GROUPED_ARGTYPES, "moe_gmm_grouped_launch")
    out = torch.empty((R, F), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), R, E, D, F,
                    is_bf16, torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"moe_gmm_grouped: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.moe_gmm_grouped")
    return out
