"""Plain PyTorch versions of the port's kernels (exact math, any device).

Counterparts of ``repro/kernels/ref.py``.  The wrappers take these for CPU
tensors only; ``chip_smoke.py`` holds each kernel against them on the card.
``xla_cumsum`` is the SSD's within-chunk prefix sum, in the reference's
order of additions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CUMSUM_BLOCK = 16


def _xla_scan(a: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last dim, in XLA:CPU's order."""
    L = a.shape[-1]
    if L <= CUMSUM_BLOCK:
        out = a.clone()
        for j in range(1, L):
            out[..., j].add_(out[..., j - 1])
        return out
    nb = -(-L // CUMSUM_BLOCK)
    if nb * CUMSUM_BLOCK > L:
        a = F.pad(a, (0, nb * CUMSUM_BLOCK - L))
    inner = _xla_scan(a.reshape(*a.shape[:-1], nb, CUMSUM_BLOCK))
    # each block plus the totals of the blocks before it
    before = F.pad(_xla_scan(inner[..., -1])[..., :-1], (1, 0))
    out = (inner + before[..., None]).reshape(*a.shape[:-1], -1)
    return out[..., :L]


class _XlaCumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, dim):
        ctx.dim = dim
        return _xla_scan(a.movedim(dim, -1)).movedim(-1, dim)

    @staticmethod
    def backward(ctx, g):
        d = ctx.dim
        return g.flip(d).cumsum(d).flip(d), None


def xla_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, added in the order of the
    reference's compiled ``jnp.cumsum``: bit for bit the same.

    XLA:CPU (as jax 0.9.0 compiles ``cumsum``) rewrites the scan into
    blocks of 16: it pads the axis at its end with zeros to a multiple of
    16, adds strictly in sequence within each block, scans the block
    totals by the same rule (a length of 16 or less is plain sequential),
    and adds each block's exclusive prefix in one last add.  The SSD takes
    ``exp`` of differences of these sums, which reach ~1e3 at a model's
    decay rates, so one last-place difference in a sum becomes ~1e-5 of
    the decay; ``torch.cumsum`` accumulates a float sum in double on the
    CPU and in CUB's order on CUDA.  So the adds are written out here, as
    f32 adds in place, one path on every device.

    The gradient is ``torch.cumsum``'s, the reversed scan of the incoming
    gradient (in double on the CPU): three kernels on the card, where the
    reference's own order (each suffix of a block summed left to right)
    takes ~26, and no check holds the gradient's order; it is within
    1e-6 of JAX's (``tests/test_torch_ssm_stages.py``).
    """
    return _XlaCumsum.apply(a, dim)


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
    acum = xla_cumsum(a, -1)
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
