"""Plain PyTorch versions of the port's kernels (exact math, any device).

Counterparts of ``repro/kernels/ref.py``.  The wrappers take these for CPU
tensors only; ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import math

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Per row ``x * rsqrt(mean(x^2) + eps) * w`` in f32, cast to x's dtype."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.to(torch.float32)).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q: [BH, Sq, hd]; k, v: [BHkv, Skv, hd].  O(S^2) oracle in f32,
    cast to q's dtype.  GQA repeats each kv head over its ``BH // BHkv``
    query heads; masked scores are ``-1e30``."""
    BH, Sq, hd = q.shape
    BHkv, Skv, _ = k.shape
    g = BH // BHkv
    k = k.repeat_interleave(g, dim=0).float()
    v = v.repeat_interleave(g, dim=0).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), k) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, *,
                        round_scores: bool = False):
    """Mamba2 SSD intra-chunk block, all in f32 (``round_scores``: the
    scores C B^T rounded to bf16, as the model's ``ssd_chunked`` rounds
    them for bf16 B and C).

    x: [BH, c, Q, P]; dt: [BH, c, Q]; A: [BH]; B, C: [BH, c, Q, N].
    Returns (y_diag [BH,c,Q,P], states [BH,c,P,N], chunk_decay [BH,c]).
    """
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    a = dt * A[:, None, None]                        # [BH, c, Q]
    acum = torch.cumsum(a, dim=-1)
    diff = acum[..., :, None] - acum[..., None, :]
    Q = x.shape[2]
    tril = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(tril, torch.exp(diff), 0.0)      # [BH, c, Q, Q]
    scores = torch.einsum("bcqn,bckn->bcqk", C, B)
    if round_scores:
        scores = scores.to(torch.bfloat16).float()
    w = scores * L * dt[..., None, :]
    y = torch.einsum("bcqk,bckp->bcqp", w, x)
    decay_to_end = torch.exp(acum[..., -1:] - acum)
    bw = B * (dt * decay_to_end)[..., None]
    st = torch.einsum("bcqp,bcqn->bcpn", x, bw)
    return y, st, torch.exp(acum[..., -1])
