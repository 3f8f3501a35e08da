"""AdamW + schedules in plain torch (counterpart of
``repro/train/optimizer.py``).

The optimizer state mirrors the parameter tree (m, v in f32).  The
arithmetic is the reference's: the global gradient norm over every leaf
(clipped to ``grad_clip`` with ``+ 1e-9``), bias correction from the
incremented step, decoupled weight decay on leaves with ``ndim >= 2`` (a
stacked per-layer vector is 2-d, so the layers' norm weights decay and
only the final norms do not, as in the reference), the update computed in
f32 and cast back to the parameter's dtype.  Unlike the reference, which
returns new arrays, ``update`` writes the new parameters and moments into
the given tensors in place (under ``torch.no_grad()``): a copy of a
full-size tree each step would cost more than the step.  The step count is
a Python int, and the schedules return the learning rate as an f32 scalar
tensor on the CPU, so that a step needs no read from the device.
``init_specs`` gives the state as meta tensors (the reference's
``ShapeDtypeStruct``s) and ``state_pspecs`` its spec tree, the moments
sharded as the parameters are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import transformer as tf

F32 = torch.float32


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def clip_scale(gnorm: torch.Tensor, clip: float) -> torch.Tensor:
    """The gradients' factor for a global norm ``gnorm``: ``min(1, clip /
    (gnorm + 1e-9))``, an f32 scalar on ``gnorm``'s device."""
    return torch.clamp(torch.div(torch.full_like(gnorm, clip),
                                 gnorm + 1e-9), max=1.0)


def bias_correction(b: float, step) -> torch.Tensor:
    """``1 - b ** step`` in f32: on the CPU for an int ``step``; a tensor
    ``step`` (the reference's traced int32 counter, as the dry run passes
    it) keeps its device."""
    s = step.to(F32) if isinstance(step, torch.Tensor) else _f32(step)
    return 1 - _f32(b) ** s


def decayed(p: torch.Tensor) -> bool:
    """Whether weight decay applies to a leaf: matrices, and the stacked
    per-layer vectors with them (``ndim >= 2``)."""
    return p.ndim >= 2


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = F32

    def init(self, params) -> AdamWState:
        def zeros(tree):
            return {k: zeros(v) if isinstance(v, dict) else
                    torch.zeros(v.shape, dtype=self.state_dtype,
                                device=v.device) for k, v in tree.items()}
        return AdamWState(step=0, m=zeros(params), v=zeros(params))

    def init_specs(self, param_specs) -> AdamWState:
        """The state of parameters ``param_specs`` (anything with
        ``.shape``) as meta tensors; the step an int32 scalar."""
        def z(tree):
            return {k: z(v) if isinstance(v, dict) else
                    torch.empty(tuple(v.shape), dtype=self.state_dtype,
                                device="meta") for k, v in tree.items()}
        return AdamWState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            m=z(param_specs), v=z(param_specs))

    def state_pspecs(self, param_pspecs) -> AdamWState:
        from repro_torch.sharding.specs import P
        return AdamWState(step=P(), m=param_pspecs, v=param_pspecs)

    def lr_at(self, step: int) -> torch.Tensor:
        """The learning rate of step ``step`` (1-based), f32."""
        return self.lr(step) if callable(self.lr) else _f32(self.lr)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One AdamW step: ``params`` and ``state``'s moments are updated
        in place and returned, with ``{"gnorm", "lr"}`` (f32 scalars;
        ``gnorm`` on the parameters' device)."""
        step = state.step + 1
        lr = self.lr_at(step)
        flat_p = [t for _, t in tf.leaves(params)]
        flat_g = [t for _, t in tf.leaves(grads)]
        flat_m = [t for _, t in tf.leaves(state.m)]
        flat_v = [t for _, t in tf.leaves(state.v)]
        dev = flat_p[0].device
        if self.grad_clip:
            gsq = torch.zeros((), dtype=F32, device=dev)
            for g in flat_g:
                gsq = gsq + g.float().square().sum()
            gnorm = torch.sqrt(gsq)
            scale = clip_scale(gnorm, self.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=F32, device=dev)
            scale = torch.ones((), dtype=F32, device=dev)

        b1, b2 = self.b1, self.b2
        # bias corrections as f32 scalars on the device: a division by a
        # host scalar may become a product with its reciprocal
        c1, c2 = (bias_correction(b, step).to(dev) for b in (b1, b2))
        lr_f = float(lr)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            g = g.float() * scale
            mf, vf = m.float(), v.float()      # the moments themselves in f32
            mf.mul_(b1).add_(g, alpha=1 - b1)
            vf.mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (mf / c1).div_((vf / c2).sqrt_().add_(self.eps))
            pf = p.float()
            if decayed(p):      # decoupled weight decay
                delta.add_(pf, alpha=self.weight_decay)
            if pf is p:
                p.sub_(delta, alpha=lr_f)
            else:
                p.copy_(pf.sub_(delta, alpha=lr_f))
            if mf is not m:
                m.copy_(mf)
                v.copy_(vf)
        return params, AdamWState(step=step, m=state.m, v=state.v), \
            {"gnorm": gnorm, "lr": lr}


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warm-up to ``peak``, then a cosine to ``floor_frac * peak``
    at ``total``; f32 arithmetic, as the reference's."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return lr


def linear_schedule(peak: float, warmup: int, total: int):
    """Linear warm-up to ``peak``, then linear decay to 0 at ``total``."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        warm = peak * s / max(warmup, 1)
        dec = peak * torch.clamp((total - s) / max(total - warmup, 1),
                                 0.0, 1.0)
        return torch.where(s < warmup, warm, dec)
    return lr
