"""Training step factory: loss -> grads -> AdamW, with optional
microbatching (sequential gradient accumulation) and the model's remat
policy (counterpart of ``repro/train/loop.py``).

Eager torch: no compile step stands in for ``jax.jit``.  The gradients are
taken with ``torch.autograd.grad`` with respect to detached aliases of the
parameters, so the caller's tensors never require grad, and a leaf the
loss does not use (a pure SSM's ``ln_ssm``) gets zeros, as ``jax.grad``
gives.  ``grad_pspecs`` pins the gradients to the parameters' specs with
``layers.constrain`` (identity on plain tensors, a redistribute of
DTensor gradients), as the reference's sharding constraint does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.layers import constrain
from repro_torch.models.model import Model
from repro_torch.sharding.specs import tree_map
from repro_torch.train.optimizer import AdamW, AdamWState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1        # sequential grad-accumulation steps
    loss_scale: float = 1.0      # static loss scaling (bf16 rarely needs it)


def value_and_grad(loss_fn, params, batch, scale: float = 1.0):
    """``(loss_fn(params, batch) * scale, [gradient of each leaf of
    params, in tf.leaves order])``, taken with respect to detached
    aliases of the parameters (a leaf the loss does not use gets
    zeros)."""
    names, ps = zip(*tf.leaves(params))
    alias = [p.detach().requires_grad_(True) for p in ps]
    with torch.enable_grad():
        loss = loss_fn(tf.unflatten(zip(names, alias)), batch) * scale
        gs = torch.autograd.grad(loss, alias, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(ps, gs)]


def microbatch(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows ``[i * b / n, (i + 1) * b / n)`` of x (b = ``x.shape[0]``), the
    reference's ``reshape(n, b // n, ...)[i]``.  A DTensor split on its
    rows is gathered for the cut and the microbatch split back the same
    way (GSPMD spreads each microbatch over the data ranks): DTensor
    cannot reshape a split dim."""
    from torch.distributed.tensor import DTensor, Replicate
    rows = x.shape[0] // n
    if not isinstance(x, DTensor) or not any(
            p.is_shard(0) for p in x.placements):
        return x.reshape(n, rows, *x.shape[1:])[i]
    from repro_torch.sharding.specs import with_placements
    pl, mesh = x.placements, x.device_mesh
    whole = with_placements(x, lambda j, p: Replicate() if p.is_shard(0)
                            else p)
    part = whole.reshape(n, rows, *x.shape[1:])[i]
    return with_placements(part, lambda j, p: pl[j] if pl[j].is_shard(0)
                           else p)


def make_train_step(model: Model, opt: AdamW,
                    tc: TrainConfig = TrainConfig(), grad_pspecs=None):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics), the parameters and moments updated in place
    (``AdamW.update``); ``metrics``: ``loss``, ``gnorm``, ``lr`` as f32
    scalar tensors.  ``grad_pspecs``: a spec tree the gradients are
    pinned to."""

    def value_and_grad_(params, batch):
        return value_and_grad(model.loss, params, batch, tc.loss_scale)

    def grads_of(params, batch):
        n = tc.microbatches
        if n == 1:
            return value_and_grad_(params, batch)
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does "
                                 f"not split into {n} microbatches")
        loss_acc, g_acc = torch.zeros((), dtype=torch.float32), None
        for i in range(n):
            mb = {k: microbatch(x, n, i) for k, x in batch.items()}
            loss, gs = value_and_grad_(params, mb)
            loss_acc = loss_acc.to(loss.device) + loss
            if g_acc is None:
                g_acc = [g.float() if g.dtype != torch.float32 else g.clone()
                         for g in gs]
            else:
                for a, g in zip(g_acc, gs):
                    a.add_(g)             # f32 accumulation
        inv = 1.0 / n
        return loss_acc * inv, [g.mul_(inv) for g in g_acc]

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = grads_of(params, batch)
        if tc.loss_scale != 1.0:
            grads = [g / tc.loss_scale for g in grads]
            loss = loss / tc.loss_scale
        names = [k for k, _ in tf.leaves(params)]
        grads = tf.unflatten(zip(names, grads))
        if grad_pspecs is not None:
            grads = tree_map(constrain, grads, grad_pspecs)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = {"loss": loss.float(), **om}
        return params, opt_state, metrics

    return train_step


def make_serve_step(model: Model):
    """serve_step(params, cache, tokens, cache_len) -> (logits, cache)."""

    def serve_step(params, cache, tokens, cache_len):
        return model.decode(params, cache, tokens, cache_len)

    return serve_step
