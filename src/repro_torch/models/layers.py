"""Core neural layers in plain torch (bf16 params / f32 statistics).

Port of ``repro/models/layers.py``.  The dtypes follow the reference step
for step: statistics in f32, results cast back to the input's dtype, and
mixed bf16 x f32 products promoted to f32 as JAX promotes them.  The
RMSNorm here is plain torch, as the reference's is jnp (the RMSNorm kernel
is reached through ``kernels.ops.rmsnorm`` only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.specs import constrain  # noqa: F401  (re-export)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def norm_shapes(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"w": (d,)}
    return {"w": (d,), "b": (d,)}


def activation(act: str):
    """``silu``, or ``jax.nn.gelu``'s default: the tanh approximation."""
    if act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def gated(act: str, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``act(g.f32)`` cast to h's dtype, times h: the gate of the GLU and
    of the experts, on each rank's shard (``on_shards``)."""
    fn = activation(act)
    return on_shards(lambda g, h: fn(g.float()).to(h.dtype) * h, g, h)


def on_shards(fn, *ts: torch.Tensor) -> torch.Tensor:
    """An elementwise ``fn`` of tensors of one shape; of DTensors on each
    rank's shards, every operand placed as the first (pending sums reduced
    first).  DTensor's own rules for the backward of some activations and
    casts gather the whole tensor on every rank."""
    from torch.distributed.tensor import DTensor
    if not any(isinstance(t, DTensor) for t in ts):
        return fn(*ts)
    from repro_torch.sharding.specs import as_placed, with_placements
    first = reduced(ts[0])
    pl = first.placements
    local = [with_placements(reduced(t), lambda i, p: pl[i]).to_local()
             for t in ts]
    return as_placed(fn(*local), first.device_mesh, pl, first.shape)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation x [..., m, k] and a weight w [k, n] (or
    a stack of them, [E, k, n] against x [E, m, k]).  On DTensors each
    rank multiplies its own shards, with the placements GSPMD gives such
    a product, per mesh dim: x's contraction split (w cut to match, the
    result a pending sum); else a stack split on both (expert
    parallelism); else x's rows split (w gathered: the FSDP all-gather);
    else w's columns split (x whole, the result split by columns); else
    w's contraction or stack split (x cut to match); else both whole.
    DTensor's own choice for ``mm`` may replicate the product instead.
    Each operand's gradient is declared with the placements the local
    product gives it.  Operands of two dtypes are promoted first, as
    ``jnp``'s ``@`` promotes them (bf16 activations against f32 weights,
    ``Model(param_dtype=torch.float32)``, multiply in f32)."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        if x.dtype != w.dtype:
            dtype = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dtype), w.to(dtype)
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last, k_w, n_w = x.device_mesh, x.ndim - 1, w.ndim - 2, w.ndim - 1
    stack = w.ndim == 3
    xp, wp, yp, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_partial():
            a = Replicate()
        if a.is_shard(last):                    # row-parallel
            r = (a, Shard(k_w), Partial(), a, Shard(k_w))
        elif stack and a.is_shard(0) and b.is_shard(0):
            r = (a, b, a, a, b)                 # expert-parallel
        elif a.is_shard():                      # rows of x: batch, seq
            r = (a, Replicate(), a, a, Partial())
        elif b.is_shard(n_w):                   # column-parallel
            r = (Replicate(), b, Shard(last), Partial(), b)
        elif b.is_shard(k_w):                   # row-parallel, x cut
            r = (Shard(last), b, Partial(), Shard(last), b)
        elif stack and b.is_shard(0):           # expert-parallel, x cut
            r = (Shard(0), b, Shard(0), Shard(0), b)
        else:
            r = (Replicate(),) * 5
        for acc, v in zip((xp, wp, yp, gx, gw), r):
            acc.append(v)
    xl = x.redistribute(mesh, xp).to_local(grad_placements=gx)
    wl = w.redistribute(mesh, wp).to_local(grad_placements=gw)
    from repro_torch.sharding.specs import as_placed
    return as_placed(xl @ wl, mesh, yp, (*x.shape[:-1], w.shape[-1]))


def split_last(t: torch.Tensor, sizes) -> list:
    """``t.split(sizes, dim=-1)``.  A DTensor split on its last dim is
    gathered for the split and each part split back the same way where
    the mesh divides it (GSPMD keeps the parts split): DTensor's own
    split leaves them whole."""
    from torch.distributed.tensor import DTensor, Replicate
    last = t.ndim - 1
    if not isinstance(t, DTensor) or not any(
            p.is_shard(last) for p in t.placements):
        return list(t.split(sizes, dim=-1))
    from repro_torch.sharding.specs import with_placements
    pl, mesh = t.placements, t.device_mesh
    whole = with_placements(t, lambda i, p: Replicate() if p.is_shard(last)
                            else p)
    out = []
    for part in whole.split(sizes, dim=-1):
        n = part.shape[-1]
        out.append(with_placements(
            part, lambda i, p: pl[i] if pl[i].is_shard(last)
            and n % mesh.size(i) == 0 else p))
    return out


def glu_mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated MLP (SwiGLU/GeGLU) or plain MLP when no gate weight exists."""
    h = dot(x, p["w_in"])
    if "w_gate" in p:
        h = gated(act, dot(x, p["w_gate"]), h)
    else:
        fn = activation(act)
        h = on_shards(lambda h: fn(h.float()).to(h.dtype), h)
    return dot(h, p["w_out"])


def mlp_shapes(d: int, f: int, gated: bool = True) -> dict:
    shapes = {"w_in": (d, f), "w_out": (f, d)}
    if gated:
        shapes["w_gate"] = (d, f)
    return shapes


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings. x: [B, S, H, hd]; positions: [S] or [B, S]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = theta ** exps
    ang = positions.float()[..., None] * freqs              # [..., S, half]
    ang = ang[..., None, :]                                 # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def split_heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """[B, S, n_heads * hd] -> [B, S, n_heads, hd].  A DTensor sharded on
    its last dim over a mesh dim whose size does not divide ``n_heads`` is
    first gathered on that mesh dim: DTensor cannot cut a shard into parts
    of heads, as GSPMD does (granite-8b's 8 kv heads on 16 ranks)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        mesh, pl = t.device_mesh, list(t.placements)
        want = [Replicate() if p.is_shard(t.ndim - 1)
                and n_heads % mesh.size(i) else p for i, p in enumerate(pl)]
        if want != pl:
            t = t.redistribute(mesh, want)
    return t.reshape(t.shape[0], -1, n_heads, hd)


def _seq_split(x) -> bool:
    """Whether x [B, S, ...] is a DTensor split on its sequence: its loss
    is taken in one chunk (a chunk of a split sequence would gather it)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and any(p.is_shard(1)
                                          for p in x.placements)


def reduced(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's pending (partial) sums reduced, so that every rank of
    those mesh dims holds the whole value (an all-reduce; identity on a
    plain tensor)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    from repro_torch.sharding.specs import with_placements
    return with_placements(t, lambda i, p: Replicate() if p.is_partial()
                           else p)


def xent_on_shards(logits, lab) -> torch.Tensor:
    """The summed cross-entropy of DTensor logits [B, c, V] against labels
    [B, c], the vocabulary split as it is (GSPMD's vocab-parallel loss):
    the log-sum-exp from each rank's sums of its shard, reduced; the
    label's logit looked up by the rank that holds it (zeros elsewhere: a
    pending sum).  DTensor's own rules for ``logsumexp`` and ``gather``
    over a split vocabulary gather the whole logits on every rank in the
    backward."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.sharding.specs import (as_placed, shard_offset,
                                            with_placements)
    logits = reduced(logits)
    pl, mesh = logits.placements, logits.device_mesh
    m = reduced(logits.detach().amax(-1, keepdim=True))
    logz = reduced((logits - m).exp().sum(-1, keepdim=True)).log() + m
    lab = with_placements(lab, lambda i, p: pl[i] if pl[i].is_shard()
                          and not pl[i].is_shard(2) else Replicate())
    local = logits.to_local()
    idx = lab.to_local().long() - shard_offset(logits, 2)
    mine = (idx >= 0) & (idx < local.shape[-1])
    gold = torch.where(mine, torch.gather(
        local, -1, idx.clamp(0, local.shape[-1] - 1)[..., None])[..., 0],
        torch.zeros((), dtype=local.dtype, device=local.device))
    gold = as_placed(gold, mesh, [Partial() if p.is_shard(2) else p
                                  for p in pl], lab.shape)
    return (logz[..., 0] - reduced(gold)).sum()


def chunked_xent(logits_fn, x: torch.Tensor, emb: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing [B, S, V] logits.

    Walks the sequence in chunks; each chunk computes logits, log-softmax
    and the label log-prob, then discards the logits.  The running total
    is an f32 sum in chunk order, as the reference's scan adds it.
    """
    B, S, _ = x.shape
    chunk = S if _seq_split(x) else min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def one(h, lab):
        logits = logits_fn(h, emb).float()
        from torch.distributed.tensor import DTensor
        if isinstance(logits, DTensor):
            return xent_on_shards(logits, lab)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab[..., None].long())[..., 0]
        return (logz - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + one(x[:, sl], labels[:, sl])
    if rem:
        total = total + one(x[:, n * chunk:], labels[:, n * chunk:])
    return total / (B * S)

