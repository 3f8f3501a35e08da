"""Flash-attention forward (GQA, causal, sliding window): wrapper of two
hand-written kernels.

Port of the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention_bhsd``.  A CPU tensor takes the plain version
(``ref.attention_ref``).  A CUDA tensor goes, by ``route``, to one of
two kernels, chosen from dtype and head dim before any launch:

- ``"tensor_core"`` (``csrc/flash_attention_tc.cu``): bf16 with
  ``hd % 8 == 0`` (TMA's 16-byte strides) and ``64 <= hd <= 256``, both
  products on the tensor cores (wgmma) with TMA-fed K/V tiles;
- ``"cuda_core"`` (``csrc/flash_attention.cu``): everything else (f32,
  whose 2e-5 tolerance TF32 would break, and other bf16 head dims), f32
  products on the CUDA cores.

It is a dispatch, not a fallback: a kernel that fails to build or launch
raises.  ``launches`` counts launches of either kernel, ``tc_launches``
those of the tensor-core kernel (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, forbid_autograd
from repro_torch.kernels.ref import attention_ref

launches = 0
tc_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256
_LIMIT = 2**30


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 + [
    ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_float]


def _fn(name: str):
    """The C entry point of one route's kernel (built at first use)."""
    if name == "tensor_core":
        fn = _build.load("flash_attention_tc").flash_attention_tc_fwd
        fn.argtypes = _ARGS + [ctypes.c_void_p]
    else:
        fn = _build.load("flash_attention").flash_attention_fwd
        fn.argtypes = _ARGS + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype, hd: int) -> str:
    """Which kernel takes a CUDA call: ``"tensor_core"`` for bf16 with
    ``hd % 8 == 0`` and ``64 <= hd <= 256``, else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and 64 <= hd <= 256:
        return "tensor_core"
    return "cuda_core"


def launch_route(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, o: torch.Tensor, *, causal: bool,
                 window: int, q_offset: int) -> None:
    """Launch route ``name``'s kernel on checked, contiguous CUDA tensors
    (``flash_attention_bhsd`` checks them; ``chip_smoke.py`` also times
    each route through this).  Counts nothing; raises if the launch
    fails."""
    BH, Sq, hd = q.shape
    BHkv, Skv, _ = k.shape
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH,
            BHkv, Sq, Skv, hd, int(bool(causal)), window, q_offset,
            float(hd ** -0.5)]
    if name != "tensor_core":
        args.append(_DTYPE_CODE[q.dtype])
    fn = _fn(name)
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({name}) launch failed: "
                           f"cudaError {err}")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, hd]; k, v: [BHkv, Skv, hd] with BH % BHkv == 0.

    Returns [BH, Sq, hd] in q's dtype (f32 or bf16; k and v share it).
    """
    global launches, tc_launches
    ts = (q, k, v)
    forbid_autograd("flash_attention_bhsd", *ts)
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
    name = route(q.dtype, hd)
    if name == "tensor_core" and any(t.data_ptr() % 16 for t in (*ts, o)):
        raise ValueError("flash_attention_bhsd: the tensor-core kernel's TMA "
                         "loads need 16-byte aligned q, k, v")
    launch_route(name, q, k, v, o, causal=causal, window=window,
                 q_offset=q_offset)
    launches += 1
    tc_launches += int(name == "tensor_core")
    return o
