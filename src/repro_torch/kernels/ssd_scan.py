"""Mamba2 SSD intra-chunk block: wrapper of two hand-written kernels.

Port of the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_intra_chunk``.
A CPU tensor takes the plain version (``ref.ssd_intra_chunk_ref``).  A
CUDA tensor goes, by ``route``, to one of two kernels, chosen from dtypes
and shapes before any launch:

- ``"tensor_core"`` (``csrc/ssd_scan_tc.cu``): bf16 ``x``, ``B``, ``C``
  with f32 ``dt`` and ``A`` (as the model gives them), ``Q % 64 == 0`` with
  ``64 <= Q <= 256``, any even ``P <= 256`` and ``N % 16 == 0`` with
  ``N <= 256``: the three products on the tensor cores (wgmma), ``B`` and
  ``C`` by TMA and read once per group by index, ``x`` by TMA where
  ``P % 16 == 0`` (mamba2's P 64) and by the block's threads for any
  other even ``P`` (hymba's P 50, whose 100-byte rows no tensor map
  takes);
- ``"cuda_core"`` (``csrc/ssd_scan.cu``): everything else (f32 inputs, the
  smoke configs' short chunks, odd ``P``, ``P > 256``), f32 products on
  the CUDA cores, register-tiled for chunks up to 128 and heads up to 128
  wide (row-blocked beyond); ``B`` and ``C`` read once per group by
  index, as on the tensor-core route.

It is a dispatch, not a fallback: a tensor the route's kernel does not
take (misaligned, too large for shared memory) raises, and a failed build
or launch raises.  ``launches`` counts launches of either kernel,
``tc_launches`` those of the tensor-core kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, forbid_autograd
from repro_torch.kernels.ref import ssd_intra_chunk_ref

launches = 0
tc_launches = 0

_BF16_FLAG = (1, 2, 4, 8, 16)          # x, dt, A, B, C
_ROUND_SCORES = 32
SMEM_LIMIT = 232448                    # bytes a block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)


def _lib(name: str) -> ctypes.CDLL:
    if name == "tensor_core":
        lib = _build.load("ssd_scan_tc")
        fn, smem = lib.ssd_intra_chunk_tc_fwd, lib.ssd_intra_chunk_tc_smem
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
    else:
        lib = _build.load("ssd_scan")
        fn, smem = lib.ssd_intra_chunk_fwd, lib.ssd_intra_chunk_smem
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem.argtypes = [ctypes.c_int64] * 3
    smem.restype = ctypes.c_int64
    return lib


def route(dtypes, Q: int, P: int, N: int) -> str:
    """Which kernel takes a CUDA call, from the dtypes of (x, dt, A, B, C)
    and the chunk's sizes: ``"tensor_core"`` for bf16 x, B, C with f32 dt,
    A and ``Q % 64 == 0``, ``64 <= Q <= 256``, ``P`` even with
    ``0 < P <= 256``, ``N % 16 == 0``, ``0 < N <= 256``; else
    ``"cuda_core"``."""
    bf, f32 = torch.bfloat16, torch.float32
    x, dt, A, B, C = dtypes
    if (x, dt, A, B, C) == (bf, f32, f32, bf, bf) and Q % 64 == 0 \
            and 64 <= Q <= 256 and P % 2 == 0 and 0 < P <= 256 \
            and N % 16 == 0 and 0 < N <= 256:
        return "tensor_core"
    return "cuda_core"


def smem_bytes(name: str, Q: int, P: int, N: int) -> int:
    """Dynamic shared memory route ``name``'s kernel needs (<= 0: a shape
    it does not take)."""
    fn = _lib(name)
    fn = fn.ssd_intra_chunk_tc_smem if name == "tensor_core" \
        else fn.ssd_intra_chunk_smem
    return int(fn(Q, P, N))


def launch_route(name: str, x, dt, A, B, C, y, st, dc, *,
                 heads: int = 1, round_scores: bool = False) -> None:
    """Launch route ``name``'s kernel on checked, contiguous CUDA tensors
    (``ssd_intra_chunk`` checks them; ``chip_smoke.py`` also times each
    route through this).  Both kernels read B and C by group (head ``bh``
    reads group ``bh // heads``).  Counts nothing; raises if the launch
    fails."""
    BH, c, Q, P = x.shape
    N = B.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if name == "tensor_core":
            err = _lib(name).ssd_intra_chunk_tc_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), st.data_ptr(), dc.data_ptr(),
                BH, heads, c, Q, P, N, int(round_scores), stream)
        else:
            flags = sum(f for f, t in zip(_BF16_FLAG, (x, dt, A, B, C))
                        if t.dtype == torch.bfloat16) \
                + _ROUND_SCORES * bool(round_scores)
            err = _lib(name).ssd_intra_chunk_fwd(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), st.data_ptr(), dc.data_ptr(),
                BH, heads, c, Q, P, N, flags, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel ({name}) launch failed: "
                           f"cudaError {err}")


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, heads: int = 1,
                    round_scores: bool = False):
    """x: [BH, c, Q, P]; dt: [BH, c, Q]; A: [BH]; B, C: [BH // heads, c, Q,
    N] (each f32 or bf16): head ``bh`` reads group ``bh // heads`` of B and
    C (``heads=1`` and no ``round_scores`` is the Pallas kernel's own
    signature and arithmetic).  ``round_scores`` rounds the scores C B^T to
    bf16 before the decay, as the model's ``ssd_chunked`` rounds them.

    Returns (y_diag [BH,c,Q,P], states [BH,c,P,N], chunk_decay [BH,c]),
    all f32.
    """
    global launches, tc_launches
    ts = (x, dt, A, B, C)
    forbid_autograd("ssd_intra_chunk", *ts)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_intra_chunk: x {tuple(x.shape)}, B "
                         f"{tuple(B.shape)}; want 4-d [BH, c, Q, *]")
    BH, c, Q, P = x.shape
    N = B.shape[-1]
    if heads < 1 or BH % heads:
        raise ValueError(f"ssd_intra_chunk: BH {BH} is not a multiple of "
                         f"heads {heads}")
    if tuple(dt.shape) != (BH, c, Q) or tuple(A.shape) != (BH,) \
            or tuple(B.shape) != (BH // heads, c, Q, N) \
            or C.shape != B.shape:
        raise ValueError(
            f"ssd_intra_chunk: shapes x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, heads {heads}; want [BH,c,Q,P], [BH,c,Q], "
            "[BH], [BH//heads,c,Q,N]")
    if all(t.device.type == "cpu" for t in ts):
        if heads > 1:
            B = B.repeat_interleave(heads, dim=0)
            C = C.repeat_interleave(heads, dim=0)
        return ssd_intra_chunk_ref(x, dt, A, B, C, round_scores=round_scores)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("ssd_intra_chunk: x, dt, A, B, C on "
                         f"{[str(t.device) for t in ts]}; all must be on one "
                         "CUDA device (or the CPU)")
    if any(t.dtype not in _DTYPES for t in ts):
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
    name = route(tuple(t.dtype for t in ts), Q, P, N)
    smem = smem_bytes(name, Q, P, N)
    if not 0 < smem <= SMEM_LIMIT or BH * c >= 2**31:
        raise ValueError(f"ssd_intra_chunk ({name}): Q {Q}, P {P}, N {N} "
                         f"need {smem} bytes of shared memory (limit "
                         f"{SMEM_LIMIT}) or BH*c {BH * c} exceeds the grid")
    if name == "tensor_core" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_intra_chunk: the tensor-core kernel's "
                         "16-byte loads need 16-byte aligned x, B, C")
    launch_route(name, x, dt, A, B, C, y, st, dc, heads=heads,
                 round_scores=round_scores)
    launches += 1
    tc_launches += int(name == "tensor_core")
    return y, st, dc
