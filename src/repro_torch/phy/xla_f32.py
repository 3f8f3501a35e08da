"""The reference's float32 arithmetic of the drifted link tables, bit for bit.

Under SNR drift the living channel recomputes every link's PER threshold
and quantized goodput from the drifted SNR in float32
(``phy.living.entry_tables``): ``pow``, ``exp``, ``log1p``, ``expm1``,
then ``ceil(per * 2^16)`` and ``rint(gbps * (1 - per) * 2^20)``.  One ulp
of ``per`` can move those integers, and with them every CRC outcome and
every rate re-selection after them.  The reference computes the chain
inside its compiled step on XLA:CPU (x86-64 with FMA), where

- ``exp`` is a Cephes-style polynomial, ``log1p`` a Cephes ``log`` with a
  rational small-argument branch, ``expm1`` a select between ``exp(x) - 1``
  and ``tanh(x / 2) * (exp(x) + 1)`` with a rational ``tanh``; the
  multiplies and adds of each are contracted into fused multiply-adds;
- ``pow(10, x)`` calls glibc's ``powf`` (the table-driven ``log2``/
  ``exp2`` of ARM's optimized routines, in double precision);
- the division of the SNR by 10 became a multiply by ``0.1f``, and the
  drift walk's interpolation and aging (``h0 + (h1 - h0) * frac``,
  ``snr - amp * u``) are fused multiply-adds too;
- denormal results are flushed to zero (FTZ/DAZ).

Torch's float32 functions differ from these by an ulp here and there, on
the CPU and on CUDA alike, so this module emulates that arithmetic with
plain IEEE float32 operations (each a separate, correctly rounded torch
op), a float32 fused multiply-add computed exactly in float64 (round to
odd, then to nearest float32), and an explicit flush to zero.  The
constants are the hexadecimal float32 values of XLA's polynomials and
glibc's tables.  It is held against the reference's compiled window
update on millions of inputs and on every window of fig9's drift points
(``tests/test_torch_living.py``).  Inputs are finite; ``per_chain`` and
``powf10`` cover the domain of the link tables (``|x log2 10| < 126``).
"""
from __future__ import annotations

import struct

import torch

f32, f64, i32, i64 = torch.float32, torch.float64, torch.int32, torch.int64
TINY = 2.0 ** -126        # smallest normal float32


def _h(bits: str) -> float:
    """A constant given as the 16 hex digits of a double (LLVM IR style)."""
    return struct.unpack(">d", bytes.fromhex(bits))[0]


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush denormal float32 values to a zero of the same sign."""
    return torch.where(x.abs() < TINY, x * 0, x)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (x86 ``vfmadd``, FTZ).

    The product of two float32 values is exact in float64; the sum is
    rounded to odd in float64 (two-sum error term), which makes the final
    rounding to float32 a correct rounding of the exact value."""
    p = a.to(f64) * torch.as_tensor(b, device=a.device).to(f64)
    cd = torch.as_tensor(c, device=a.device).to(f64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(i64)
    odd = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)
    bits = torch.where(odd, torch.where(away, bits + 1, bits - 1), bits)
    return ftz(bits.view(f64).to(f32))


def _k(bits: str, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(_h(bits), dtype=f32, device=like.device)


def _poly(y, x, coeffs):
    for c in coeffs:
        y = fma(y, x, _k(c, x))
    return y


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``exp``."""
    t = torch.clamp(x, _h("C055F33340000000"), _h("4056333340000000"))
    n = torch.floor(fma(t, _k("3FF7154760000000", x), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma(-n, _k("3FE6300000000000", x), t)
    r = fma(-n, _k("BF2BD01060000000", x), r)
    y = fma(_k("3F2A0D2CE0000000", x), r, _k("3F56E879C0000000", x))
    y = _poly(y, r, ("3F81112100000000", "3FA5553820000000",
                     "3FC5555540000000", "3FE0000000000000"))
    y = ftz(fma(y, ftz(r * r), r) + 1.0)
    return ftz(y * ((n.to(i32) + 127) << 23).view(f32))


def _log_f32(w: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` for positive finite ``w``."""
    bits = torch.clamp(w, min=TINY).view(i32)
    e = ftz((((bits >> 23) & 0xFF) - 127).to(f32) + 1.0)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)
    low = m < _h("3FE6A09E60000000")
    x = ftz(ftz(m - 1.0) + torch.where(low, m, 0.0))
    e = torch.where(low, ftz(e - 1.0), e)
    z = ftz(x * x)
    x3 = ftz(z * x)
    a = _poly(fma(_k("3FB2043760000000", x), x, _k("BFBD7A3700000000", x)),
              x, ("3FBDE4A340000000",))
    b = _poly(fma(_k("BFBFCBA9E0000000", x), x, _k("3FC23D37E0000000", x)),
              x, ("BFC555CA00000000",))
    c = _poly(fma(_k("3FC999D580000000", x), x, _k("BFCFFFFF80000000", x)),
              x, ("3FD5555540000000",))
    y = fma(fma(x3, a, b), x3, c)
    t = fma(x3, y, ftz(e * _h("BF2BD01060000000")))
    res = ftz(fma(-z, 0.5, x) + t)
    return fma(_k("3FE6300000000000", x), e, res)


def log1p_neg_f32(b: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p(-b)`` for ``b`` in ``[0, 1)``."""
    sq = ftz(b * b)
    z0 = ftz(b * -0.0)
    den = ftz(z0 + 1.0)
    for c in ("402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
              "4073519460000000", "406B0DB140000000", "404E0F3040000000"):
        den = fma(-b, den, _k(c, b))
    num = ftz(z0 + _h("3F07BC0960000000"))
    for c in ("3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
              "404E798EC0000000", "404C8E75A0000000", "40340A2020000000"):
        num = fma(-b, num, _k(c, b))
    q = ftz(ftz(sq * b) * ftz(num / den))
    small = ftz(fma(sq, -0.5, -q) - b)
    return torch.where(b.abs() < _h("3FDA8279A0000000"), small,
                       _log_f32(ftz(1.0 - b)))


def _tanh_f32(h: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(h, _h("C01FFEC880000000"), _h("401FFEC880000000"))
    s = ftz(c * c)
    y = _poly(fma(_k("BCB3E4B800000000", h), s, _k("3D4C266FC0000000", h)),
              s, ("BDD7A6FFE0000000", "3E6B800820000000", "3EEF286940000000",
                  "3F44E1BDA0000000", "3F740B3B80000000"))
    den = _poly(fma(_k("3EB41A7B00000000", h), s, _k("3F1F12BAC0000000", h)),
                s, ("3F629540A0000000", "3F740B3BA0000000"))
    t = ftz(ftz(c * y) / den)
    t = torch.where(h.abs() < _h("3F3A36E2E0000000"), h, t)
    return torch.where(h.abs() >= 20.0, torch.copysign(torch.ones_like(h), h),
                       t)


def expm1_f32(m: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``expm1``."""
    e = exp_f32(m)
    h = ftz(m * 0.5)
    out = ftz(_tanh_f32(h) * ftz(e + 1.0))
    out = torch.where(m.abs() > 0.5, ftz(e - 1.0), out)
    return torch.where(h == 0, m, out)


# glibc 2.36 powf: log2(10) from the log2 table (entry 13, z = 1.25, k = 3)
# with fused multiply-adds, then exp2 by a 32-entry table and a cubic
LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_EXP2_SHIFT_BITS = 0x42E8000000000000
_EXP2_C = tuple(float.fromhex(h) for h in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
_EXP2_TAB = tuple(int(h, 16) for h in """
3ff0000000000000 3fefd9b0d3158574 3fefb5586cf9890f 3fef9301d0125b51
3fef72b83c7d517b 3fef54873168b9aa 3fef387a6e756238 3fef1e9df51fdee1
3fef06fe0a31b715 3feef1a7373aa9cb 3feedea64c123422 3feece086061892d
3feebfdad5362a27 3feeb42b569d4f82 3feeab07dd485429 3feea47eb03a5585
3feea09e667f3bcd 3fee9f75e8ec5f74 3feea11473eb0187 3feea589994cce13
3feeace5422aa0db 3feeb737b0cdc5e5 3feec49182a3f090 3feed503b23e255d
3feee89f995ad3ad 3feeff76f2fb5e47 3fef199bdd85529c 3fef3720dcef9069
3fef5818dcfba487 3fef7c97337b9b5f 3fefa4afa2a490da 3fefd0765b6e4540
""".split())


def powf10(x: torch.Tensor) -> torch.Tensor:
    """glibc's float32 ``powf(10, x)`` for ``|x log2 10| < 126``."""
    xd = x.to(f64) * LOG2_10
    kd = xd + _EXP2_SHIFT                 # round(xd * 32) in the low bits
    j = kd.view(i64) - _EXP2_SHIFT_BITS
    r = xd - (kd - _EXP2_SHIFT)
    tab = torch.tensor(_EXP2_TAB, dtype=i64, device=x.device)
    s = (tab[j % 32] + j * (1 << 47)).view(f64)
    y = (_EXP2_C[0] * r + _EXP2_C[1]) * (r * r) + (_EXP2_C[2] * r + 1.0)
    return ftz((y * s).to(f32))


def per_chain(p: torch.Tensor, gain: torch.Tensor, bits: torch.Tensor):
    """Packet error rate from ``p = 10^(snr/10)``: the reference's
    ``-expm1(bits * log1p(-min(0.5 * exp(-(p * gain) / 2), 0.999999)))``
    (``gain``/``bits`` broadcast against ``p``)."""
    t = ftz(ftz(p * -gain) * 0.5)
    ber = torch.clamp(ftz(exp_f32(t) * 0.5), max=_h("3FEFFFFDE0000000"))
    return -expm1_f32(ftz(log1p_neg_f32(ber) * bits))
