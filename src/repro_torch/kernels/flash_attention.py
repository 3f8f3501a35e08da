"""Flash-attention forward (GQA, causal, sliding window): wrapper of
``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd``.  A CPU tensor takes the plain version
(``ref.attention_ref``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback.  ``launches`` counts kernel launches (and
nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256
_LIMIT = 2**30


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, hd]; k, v: [BHkv, Skv, hd] with BH % BHkv == 0.

    Returns [BH, Sq, hd] in q's dtype (f32 or bf16; k and v share it).
    """
    global launches
    ts = (q, k, v)
    if all(t.device.type == "cpu" for t in ts):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("flash_attention_bhsd: q, k, v on "
                         f"{[str(t.device) for t in ts]}; all must be on one "
                         "CUDA device (or the CPU)")
    if any(t.dim() != 3 for t in ts) or k.shape != v.shape \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_bhsd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}; want "
                         "[BH, Sq, hd] and [BHkv, Skv, hd]")
    BH, Sq, hd = q.shape
    BHkv, Skv, _ = k.shape
    if BHkv == 0 or BH % BHkv:
        raise ValueError(f"flash_attention_bhsd: BH {BH} is not a multiple "
                         f"of BHkv {BHkv}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"flash_attention_bhsd: head dim {hd} outside "
                         f"[1, {MAX_HD}]")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_bhsd: dtypes {q.dtype}, {k.dtype},"
                        f" {v.dtype}; want float32 or bfloat16, one for all")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bhsd: q, k, v must be contiguous")
    if Sq >= _LIMIT or Skv >= _LIMIT or -(-Sq // 64) > 65535 \
            or not 0 <= window < _LIMIT or not -_LIMIT < q_offset < _LIMIT \
            or BH >= 2**31:
        raise ValueError("flash_attention_bhsd: sizes beyond the kernel's "
                         f"limits (BH {BH}, Sq {Sq}, Skv {Skv}, window "
                         f"{window}, q_offset {q_offset})")
    o = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return o
    if Skv == 0:
        raise ValueError("flash_attention_bhsd: no keys (Skv = 0)")
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, BHkv,
            Sq, Skv, hd, int(bool(causal)), window, q_offset,
            float(hd ** -0.5), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return o
