"""Public functions over the port's kernels (counterpart of
``repro/kernels/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd


class _RMSNorm(torch.autograd.Function):
    """Kernel forward; analytic backward in plain torch, exactly the
    reference's ``_rmsnorm_bwd`` (which is jnp, not Pallas)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        return _rn.rmsnorm_2d(x2, w, eps=eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        f32 = torch.float32
        xf, dyf, wf = x.to(f32), dy.to(f32), w.to(f32)
        n = x.shape[-1]
        ms = (xf * xf).mean(-1, keepdim=True)
        r = torch.rsqrt(ms + ctx.eps)
        g = dyf * wf                                   # [..., d]
        dx = r * g - xf * (r ** 3) * (g * xf).mean(-1, keepdim=True)
        dw = (dyf * xf * r).reshape(-1, n).sum(0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d] -> fused RMSNorm * w (autograd: analytic backward)."""
    return _RMSNorm.apply(x, w, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Skv, Hkv, hd] -> [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, hd).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, hd).contiguous()
    out = _fa.flash_attention_bhsd(qf, kf, vf, causal=causal, window=window,
                                   q_offset=q_offset)
    return out.reshape(B, H, Sq, hd).transpose(1, 2)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 128):
    """Full SSD: the intra-chunk kernel plus the inter-chunk recurrence.

    x: [b, l, h, p]; dt: [b, l, h]; A: [h]; B, C: [b, l, n].
    Returns (y [b, l, h, p] in x's dtype, final_state [b, h, p, n] f32).
    The recurrence is a loop over chunks in torch, as the reference's is a
    ``lax.scan``: chunk states carried in bf16, accumulated in f32.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"ssd: length {l} is not a multiple of the chunk "
                         f"{chunk}")
    c = l // chunk

    # layout for the kernel: one cell per (batch*head, chunk); B and C stay
    # one copy per batch row, read by the h heads of that row (``heads``)
    xk = x.permute(0, 2, 1, 3).reshape(b * h, c, chunk, p).contiguous()
    dtk = dt.permute(0, 2, 1).reshape(b * h, c, chunk).contiguous()
    Bk = B.reshape(b, c, chunk, n).contiguous()
    Ck = C.reshape(b, c, chunk, n).contiguous()
    Ak = A[None, :].expand(b, h).reshape(b * h).contiguous()

    y_diag, states, decay = _ssd.ssd_intra_chunk(xk, dtk, Ak, Bk, Ck,
                                                 heads=h)

    # inter-chunk recurrence: the state carried into each chunk
    states = states.to(torch.bfloat16).float()
    carry = torch.zeros((b * h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * decay[:, i, None, None] + states[:, i]
    prev = torch.stack(prev, dim=1).to(torch.bfloat16)     # [bh, c, p, n]

    # off-diagonal: carried-in state contribution; JAX promotes the mixed
    # dtypes of this einsum, torch needs them cast to the promoted type
    a = dtk * Ak[:, None, None]
    state_decay = torch.exp(_ref.xla_cumsum(a, -1))        # [bh, c, Q]
    dtype = torch.promote_types(torch.promote_types(Ck.dtype, prev.dtype),
                                state_decay.dtype)
    y_off = torch.einsum("bcqn,bhcpn,bhcq->bhcqp", Ck.to(dtype),
                         prev.to(dtype).reshape(b, h, c, p, n),
                         state_decay.to(dtype).reshape(b, h, c, chunk))
    y = (y_diag.reshape(b, h, c, chunk, p) + y_off).reshape(b, h, l, p) \
        .permute(0, 2, 1, 3)
    return y.to(x.dtype), carry.reshape(b, h, p, n)
