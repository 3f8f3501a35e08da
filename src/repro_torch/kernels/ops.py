"""Public functions over the port's kernels (counterpart of
``repro/kernels/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import rmsnorm as _rn


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
