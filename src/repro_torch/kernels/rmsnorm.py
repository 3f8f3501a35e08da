"""Fused RMSNorm(+scale) forward: wrapper of ``csrc/rmsnorm.cu``.

Port of the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm_2d``.  A CPU
tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
``launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def rmsnorm_2d(x: torch.Tensor, w: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """x: [rows, d] f32/bf16, w: [d] of x's dtype -> [rows, d] in x's dtype."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rmsnorm_2d: x on {x.device}, w on {w.device}; "
                         "both must be on one CUDA device (or the CPU)")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm_2d: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}; want [rows, d] and [d]")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm_2d: dtypes x {x.dtype}, w {w.dtype}; "
                        "want float32 or bfloat16, the same for both")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_2d: x and w must be contiguous")
    rows, d = x.shape
    if rows >= 2**31:
        raise ValueError(f"rmsnorm_2d: {rows} rows exceed the grid limit")
    y = torch.empty_like(x)
    if rows == 0 or d == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              rows, d, float(eps), _DTYPE_CODE[x.dtype],
                              stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    launches += 1
    return y
