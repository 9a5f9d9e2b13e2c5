"""MoE grouped matmul: the wrapper of ``csrc/moe_gmm.cu``.

Replaces the TPU kernel ``src/repro/kernels/moe_gmm.py:47`` (``moe_gmm``;
its plain version is :func:`repro_torch.kernels.ref.moe_gmm_ref`):
``out[e] = buf[e] @ w[e]`` for (E, C, D) x (E, D, F) -> (E, C, F),
accumulated in float32 and written in buf's dtype. The wrapper checks
what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused. It never falls
back to the plain version: :mod:`repro_torch.kernels.ops` routes CPU
tensors there before this module is reached.

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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# kernel launches since the last ops.reset_launch_counts()
launches = 0

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


def moe_gmm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
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
    launches += 1
    return out
