"""Mamba2 SSD intra-chunk block: wrapper of ``csrc/ssd_scan.cu``.

Port of the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_intra_chunk``.
A CPU tensor takes the plain version (``ref.ssd_intra_chunk_ref``); a CUDA
tensor launches the hand-written kernel or raises — there is no fallback.
``launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_intra_chunk_ref

launches = 0

_BF16_FLAG = (1, 2, 4, 8, 16)          # x, dt, A, B, C
SMEM_LIMIT = 232448                    # bytes a block may use on Hopper


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_intra_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = lib.ssd_intra_chunk_smem
    smem.argtypes = [ctypes.c_int64] * 3
    smem.restype = ctypes.c_int64
    return lib


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor):
    """x: [BH, c, Q, P]; dt: [BH, c, Q]; A: [BH]; B, C: [BH, c, Q, N]
    (each f32 or bf16).

    Returns (y_diag [BH,c,Q,P], states [BH,c,P,N], chunk_decay [BH,c]),
    all f32.
    """
    global launches
    ts = (x, dt, A, B, C)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_intra_chunk_ref(x, dt, A, B, C)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("ssd_intra_chunk: x, dt, A, B, C on "
                         f"{[str(t.device) for t in ts]}; all must be on one "
                         "CUDA device (or the CPU)")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_intra_chunk: x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}; want 4-d [BH, c, Q, *]")
    BH, c, Q, P = x.shape
    N = B.shape[-1]
    if tuple(dt.shape) != (BH, c, Q) or tuple(A.shape) != (BH,) \
            or tuple(B.shape) != (BH, c, Q, N) or C.shape != B.shape:
        raise ValueError(
            f"ssd_intra_chunk: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}; want [BH,c,Q,P], [BH,c,Q], [BH], [BH,c,Q,N]")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in ts):
        raise TypeError("ssd_intra_chunk: dtypes "
                        f"{[str(t.dtype) for t in ts]}; each must be float32 "
                        "or bfloat16")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_intra_chunk: inputs must be contiguous")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((BH, c, Q, P), **f32)
    st = torch.empty((BH, c, P, N), **f32)
    dc = torch.empty((BH, c), **f32)
    if BH * c == 0:
        return y, st, dc
    lib = _lib()
    smem = lib.ssd_intra_chunk_smem(Q, P, N)
    if not 0 < smem <= SMEM_LIMIT or BH * c >= 2**31:
        raise ValueError(f"ssd_intra_chunk: Q {Q}, P {P}, N {N} need {smem} "
                         f"bytes of shared memory (limit {SMEM_LIMIT}) or "
                         f"BH*c {BH * c} exceeds the grid")
    flags = sum(f for f, t in zip(_BF16_FLAG, ts)
                if t.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_intra_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), st.data_ptr(), dc.data_ptr(), BH, c,
            Q, P, N, flags, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {err}")
    launches += 1
    return y, st, dc
