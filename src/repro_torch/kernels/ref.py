"""Plain PyTorch versions of the port's kernels (exact math, any device).

Counterparts of ``repro/kernels/ref.py``.  The wrappers take these for CPU
tensors only; ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Per row ``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast to x's dtype."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(torch.float32)).to(x.dtype)
