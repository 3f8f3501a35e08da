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


def glu_mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Gated MLP (SwiGLU/GeGLU) or plain MLP when no gate weight exists."""
    h = x @ p["w_in"]
    fn = activation(act)
    if "w_gate" in p:
        g = x @ p["w_gate"]
        h = fn(g.float()).to(h.dtype) * h
    else:
        h = fn(h.float()).to(h.dtype)
    return h @ p["w_out"]


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


def chunked_xent(logits_fn, x: torch.Tensor, emb: torch.Tensor,
                 labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materializing [B, S, V] logits.

    Walks the sequence in chunks; each chunk computes logits, log-softmax
    and the label log-prob, then discards the logits.  The running total
    is an f32 sum in chunk order, as the reference's scan adds it.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    n = S // chunk
    rem = S - n * chunk

    def one(h, lab):
        logits = logits_fn(h, emb).float()
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

