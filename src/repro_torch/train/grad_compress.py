"""Gradient compression for data-parallel reduction: int8 quantization with
error feedback, over an explicit ``torch.distributed`` all-reduce
(counterpart of ``repro/train/grad_compress.py``).

WiMCS connection (DESIGN.md §2.2): the paper's axis is pJ/bit of moved
data; int8 compression cuts DP gradient wire bytes 4x, which the
interconnect fabric model translates directly into energy (and the
collective roofline term into time).  Error feedback keeps the update
unbiased over time: the quantization residual is carried and re-added to
the next step's gradient (Seide et al.; Karimireddy et al.).

One process per DP rank: the parameters are replicated, each rank takes
its slice of the global batch (by its coordinate over the ("pod",
"data") axes), and the gradients, loss and metrics are reduced over
those axes' groups.  The reduction keeps the reference's formulation: each
rank quantizes ``g + err`` to int8 codes and one f32 scale, and the
*dequantized* f32 values are summed (the reference's ``psum(deq)``), not
the codes (a sum of codes under per-rank scales would be another result).
What crosses the wire is the int8 codes and the scale: every rank gathers
every rank's (a one-shot schedule, ``scheduler.oneshot_cost``),
dequantizes them and adds them in DP-rank order, the order in which
XLA:CPU sums the reference's ``psum`` — so the mean is the reference's bit
for bit, where a ring all-reduce of the f32 values would sum in another
order.

Codes, scales and residuals are the compiled reference's bit for bit.
``torch.round`` rounds half to even as ``jnp.round`` does, and ``g /
scale`` is a true f32 division on the device (no host scalar, which CUDA
would turn into a product with its reciprocal).  Two of the reference's
operations XLA compiles to another rounding, and the port writes them out
as compiled: the division by the constant ``qmax`` becomes a product with
its f32 reciprocal, and the residual ``gf - q * scale`` one fused
multiply-add (``_residual``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.interconnect.scheduler import psum
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import transformer as tf
from repro_torch.sharding.specs import dp_axes
from repro_torch.train.loop import value_and_grad

F32 = torch.float32
CHUNK = 1 << 24          # elements per f64 block of ``_residual``


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    bits: int = 8
    error_feedback: bool = True


def quantize(g: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor quantization -> (int8 codes, f32 scale)."""
    gf = g.float()
    qmax = torch.tensor(2 ** (bits - 1) - 1, dtype=F32)
    inv = (torch.ones((), dtype=F32) / qmax).to(g.device)  # f32 1 / qmax
    qmax = qmax.to(g.device)
    scale = torch.clamp(gf.abs().max(), min=1e-12) * inv
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _residual(gf: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
              ) -> torch.Tensor:
    """``gf - q * scale`` rounded once to f32 (an FMA).  Taken in f64,
    where it is exact: ``q * scale`` has at most 31 significant bits, and
    where ``q != 0`` both terms are multiples of ``ulp(scale) / 2`` with a
    difference below ``2 * scale``.  In blocks, to bound the f64
    temporaries."""
    out = torch.empty_like(gf)
    g, c, o = gf.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for i in range(0, g.numel(), CHUNK):
        o[i:i + CHUNK] = (g[i:i + CHUNK].double()
                          - c[i:i + CHUNK].double() * s).float()
    return out


def gather(x: torch.Tensor, mesh, axes) -> list:
    """Every DP rank's ``x`` (over ``axes``, the first major), in DP-rank
    order."""
    parts = [x]
    for a in reversed(tuple(axes)):
        group = mesh.get_group(a)
        blk = torch.stack(parts)
        out = [torch.empty_like(blk) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, blk, group=group)
        parts = [p for b in out for p in b.unbind(0)]
    return parts


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh, axes,
                    cc: CompressionConfig):
    """One tensor: error-feedback int8 all-reduce over ``axes``.

    Returns (mean gradient in ``g``'s dtype, new f32 error residual)."""
    gf = g.float() + err
    q, scale = quantize(gf, cc.bits)
    new_err = _residual(gf, q, scale) if cc.error_feedback \
        else torch.zeros_like(gf)
    # wire format: int8 codes + one f32 scale per rank
    codes, scales = gather(q, mesh, axes), gather(scale, mesh, axes)
    total = dequantize(codes[0], scales[0])
    for c, sc in zip(codes[1:], scales[1:]):
        total = total + dequantize(c, sc)
    n = torch.tensor(len(codes), dtype=F32, device=g.device)
    return (total / n).to(g.dtype), new_err


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    n = torch.tensor(math.prod(axis_sizes(mesh)[a] for a in axes),
                     dtype=x.dtype, device=x.device)
    return psum(x, axes, mesh=mesh) / n


def dp_index(mesh) -> tuple:
    """(this rank's index among the DP ranks, their number): its
    coordinate over the ("pod", "data") axes, row-major."""
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in dp_axes(mesh):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def make_dp_train_step(model, opt, mesh, cc: CompressionConfig,
                       device=None):
    """Pure-DP trainer with compressed gradient exchange.

    Parameters are replicated across the DP axes (suitable for models that
    fit one device); the gradient all-reduce runs through the int8+error-
    feedback wire format.  ``device`` is the ranks' device (default the
    card, raising without one; ``"cpu"`` for gloo ranks) and must be the
    mesh's.  Returns train_step(params, opt_state, err, batch) -> (params,
    opt_state, err, metrics), ``batch`` the global batch (every rank
    passes the same), the parameters and moments updated in place."""
    dev = _device.resolve(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh on {mesh.device_type}, device {dev}")
    dp = dp_axes(mesh)

    def reduce_one(g, e):
        if not cc.enabled:
            return pmean(g, mesh, dp), e
        return compressed_psum(g, e, mesh, dp, cc)

    def train_step(params, opt_state, err, batch):
        i, n = dp_index(mesh)
        local = {}
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows does "
                                 f"not split over {n} DP ranks")
            b = x.shape[0] // n
            local[k] = x[i * b:(i + 1) * b]
        loss, grads = value_and_grad(model.loss, params, local)
        names = [k for k, _ in tf.leaves(params)]
        red = [reduce_one(g, e) for g, (_, e) in zip(grads, tf.leaves(err))]
        grads = tf.unflatten(zip(names, [r[0] for r in red]))
        new_err = tf.unflatten(zip(names, [r[1] for r in red]))
        params, opt_state, om = opt.update(grads, opt_state, params)
        loss = pmean(loss.float(), mesh, dp)
        return params, opt_state, new_err, {"loss": loss, **om}

    return train_step


def init_error(params) -> Any:
    return {k: init_error(v) if isinstance(v, dict) else
            torch.zeros(v.shape, dtype=F32, device=v.device)
            for k, v in params.items()}


def wire_bytes_per_step(params, cc: CompressionConfig) -> float:
    """Bytes on the DP wire per step (for the fabric energy model)."""
    n = sum(int(p.numel()) for _, p in tf.leaves(params))
    per_elem = cc.bits / 8 if cc.enabled else 2.0   # bf16 baseline
    return n * per_elem
