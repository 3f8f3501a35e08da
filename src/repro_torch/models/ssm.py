"""Mamba2 / SSD (state-space duality) sequence mixer [arXiv:2405.21060].

Port of ``repro/models/ssm.py``.  Training/prefill uses the chunked SSD
algorithm (quadratic within a chunk, linear state passing across chunks:
a Python loop over the chunks takes the place of ``lax.scan``); decode
uses the O(1) recurrent update.

The dtypes follow the reference step for step: with bf16 ``B``/``C`` the
``scores`` product is rounded to bf16, the chunk states are rounded to
bf16 and carried in f32, and ``y`` stays f32 until the layer casts it.
JAX's einsums promote mixed operands and accumulate in the promoted type;
torch needs the casts written out.

``ssd_chunked(..., impl=)``: ``"naive"`` and ``"blockwise"`` keep the
reference's jnp formulation; ``"pallas"`` takes the intra-chunk block
(``L``, ``scores``, ``y_diag``, the chunk states and their decay) from
``kernels.ssd_scan.ssd_intra_chunk``, the counterpart of the Pallas kernel
that the reference's docstring names for this block, and keeps the rest
(the bf16 states, the f32 recurrence, ``y_off``).  The kernel rounds
``C B^T`` to bf16 where the reference's ``scores`` are bf16
(``round_scores``), so that only its f32 sums, which run in another
order, differ from the reference's arithmetic; the Pallas kernel's own
f32 scores would differ in every entry, and a deep stack of random-weight
layers amplifies any difference (ROADMAP §C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ref import xla_cumsum
from repro_torch.models.layers import dot, split_last
from repro_torch.sharding import specs as sh

# leaves the reference declares f32 whatever the model's dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


def ssm_shapes(cfg: ModelConfig) -> dict:
    """The layer's parameter shapes (the reference's ``ssm_spec``); the
    leaves named in ``F32_LEAVES`` are f32, the rest take the model's
    dtype."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"w_xz": (d, 2 * di), "w_bc": (d, 2 * N), "w_dt": (d, H),
            "a_log": (H,), "dt_bias": (H,), "d_skip": (H,),
            "w_out": (di, d), "norm_w": (di,)}


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum from the prefix sums ``cs = xla_cumsum(a, -1)``:
    out[..., i, j] = sum_{j < m <= i} a[..., m], the reference's
    ``_segsum(a)``."""
    T = cs.shape[-1]
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=cs.device))
    return torch.where(mask, out, -torch.inf)


def _promoted(*ts) -> torch.dtype:
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _intra_reference(xb, dtb, A, Bb, Cb, a_cum):
    """The reference's intra-chunk block in torch, from the prefix sums
    ``a_cum = xla_cumsum(dt A, 2)``: (y_diag [b,c,q,h,p], states
    [b,c,h,p,n] before their bf16 rounding, chunk_decay [b,c,h])."""
    Lmat = torch.exp(_segsum(a_cum.permute(0, 1, 3, 2)))   # [b,c,h,q,q]
    scores = torch.einsum("bcqn,bckn->bcqk", Cb.float(), Bb.float()) \
        .to(_promoted(Cb, Bb))                              # [b,c,q,k]
    t = _promoted(Lmat, scores, dtb, xb)
    w = Lmat.to(t) * scores[:, :, None].to(t) \
        * dtb.permute(0, 1, 3, 2)[:, :, :, None, :].to(t)  # [b,c,h,q,k]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", w, xb.to(t))
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [b,c,q,h]
    t = _promoted(Bb, dtb, decay_to_end, xb)
    wx = xb.to(t) * (dtb * decay_to_end).to(t)[..., None]  # [b,c,q,h,p]
    states = torch.einsum("bcqn,bcqhp->bchpn", Bb.to(t), wx)
    return y_diag, states, torch.exp(a_cum[:, :, -1, :])


def _intra_kernel(xb, dtb, A, Bb, Cb):
    """The intra-chunk block through ``ssd_scan.ssd_intra_chunk`` (B and C
    read once per batch row by index: ``heads=h``)."""
    b, c, q, h, p = xb.shape
    n = Bb.shape[-1]
    xk = xb.permute(0, 3, 1, 2, 4).reshape(b * h, c, q, p).contiguous()
    dtk = dtb.permute(0, 3, 1, 2).reshape(b * h, c, q).contiguous()
    Ak = A.float().repeat(b).contiguous()                  # A[bh % h]
    y, st, dc = ssd_scan.ssd_intra_chunk(
        xk, dtk, Ak, Bb.contiguous(), Cb.contiguous(), heads=h,
        round_scores=_promoted(Cb, Bb) == torch.bfloat16)
    return (y.reshape(b, h, c, q, p).permute(0, 2, 3, 1, 4),
            st.reshape(b, h, c, p, n).permute(0, 2, 1, 3, 4),
            dc.reshape(b, h, c).permute(0, 2, 1))


def ssd_chunked(x, dt, A, B, C, chunk: int, *, impl: str = "naive"):
    """SSD forward.

    x:  [b, l, h, p]   inputs per head
    dt: [b, l, h]      positive step sizes
    A:  [h]            negative decay rates
    B, C: [b, l, n]    input/output projections (single group)
    Returns y: [b, l, h, p] (f32 for f32 dt), final_state: [b, h, p, n] f32.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    if l % chunk:
        raise ValueError(f"ssd_chunked: length {l} is not a multiple of "
                         f"the chunk {chunk}")
    c = l // chunk
    xb = x.reshape(b, c, chunk, h, p)
    dtb = dt.reshape(b, c, chunk, h)
    Bb = B.reshape(b, c, chunk, n)
    Cb = C.reshape(b, c, chunk, n)

    a = dtb * A[None, None, None, :]                       # [b,c,q,h]
    a_cum = xla_cumsum(a, 2)
    if impl == "pallas":
        y_diag, states, chunk_decay = _intra_kernel(xb, dtb, A, Bb, Cb)
    else:
        y_diag, states, chunk_decay = _intra_reference(xb, dtb, A, Bb, Cb,
                                                       a_cum)
    # chunk states stored in bf16, the recurrence accumulates in f32
    states = states.to(torch.bfloat16)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] \
            + states[:, i].float()
    prev_states = torch.stack(prev, dim=1).to(torch.bfloat16) \
        .to(x.dtype)                                       # [b,c,h,p,n]

    # off-diagonal term: contribution of the carried-in state
    state_decay = torch.exp(a_cum)                         # [b,c,q,h]
    t = _promoted(Cb, prev_states, state_decay)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cb.to(t), prev_states.to(t)) \
        * state_decay.to(t)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry


def ssd_on_shards(x, dt, A, B, C, chunk: int, *, impl: str = "naive"):
    """``ssd_chunked`` of DTensors, each rank on its own batch rows and
    heads as x is split (its sequence and head dim gathered): dt and A
    cut to the rank's heads, B and C to its rows.  The chunked SSD is
    local to a (row, head) block; DTensor has no sharding rule for its
    einsums over rows and heads split on two mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = sh.with_placements(x, lambda i, p: p if p.is_shard(0)
                           or p.is_shard(2) else Replicate())
    pl, mesh = x.placements, x.device_mesh

    def like(shard_h):
        return [Shard(0) if p.is_shard(0) else Shard(shard_h)
                if p.is_shard(2) else Replicate() for p in pl]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    heads = [Shard(0) if p.is_shard(2) else Replicate() for p in pl]
    # A's gradient on a rank covers its own rows only, B's and C's its own
    # heads
    g_heads = [Shard(0) if p.is_shard(2) else Partial() if p.is_shard(0)
               else Replicate() for p in pl]
    g_rows = [Shard(0) if p.is_shard(0) else Partial() if p.is_shard(2)
              else Replicate() for p in pl]
    y, final = ssd_chunked(
        x.to_local(), dt.redistribute(mesh, like(2)).to_local(),
        A.redistribute(mesh, heads).to_local(grad_placements=g_heads),
        B.redistribute(mesh, rows).to_local(grad_placements=g_rows),
        C.redistribute(mesh, rows).to_local(grad_placements=g_rows), chunk,
        impl=impl)
    b, _, h, p_ = x.shape
    return (sh.as_placed(y, mesh, pl, x.shape),
            sh.as_placed(final, mesh, like(1), (b, h, p_, B.shape[-1])))


def recur(s, dt1, A, b, x, c):
    """One O(1) decode step: s' = s * exp(dt A) + dt * B (x) x; y = C . s'.
    s [B,H,P,N] f32, dt1 [B,H], A [H], b and c [B,N], x [B,H,P] ->
    (y [B,H,P], s')."""
    decay = torch.exp(dt1 * A[None, :])
    upd = b.float()[:, None, None, :] \
        * (dt1[:, :, None] * x.float())[..., None]
    s_new = s * decay[..., None, None] + upd
    return torch.einsum("bn,bhpn->bhp", c.float(), s_new), s_new


def recur_on_shards(s, dt1, A, b, x, c):
    """``recur`` with a DTensor state, each rank on its own rows and heads
    as the state is split (its P and N gathered): the step is local to a
    (row, head) block."""
    from torch.distributed.tensor import Replicate, Shard
    s = sh.with_placements(s, lambda i, p: p if p.is_shard(0)
                           or p.is_shard(1) else Replicate())
    pl, mesh = s.placements, s.device_mesh
    bh = [Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(1)
          else Replicate() for p in pl]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    heads = [Shard(0) if p.is_shard(1) else Replicate() for p in pl]

    def on(t, want):
        return sh.with_placements(
            t, lambda i, p: want[i]).to_local()
    y, s_new = recur(s.to_local(), on(dt1, bh), on(A, heads), on(b, rows),
                     on(x, bh), on(c, rows))
    return (sh.as_placed(y, mesh, bh, x.shape),
            sh.as_placed(s_new, mesh, pl, s.shape))


def _project(x, p, cfg: ModelConfig):
    """The layer's input projections: (x heads [B,S,H,P], gate z, B, C,
    dt [B,S,H] f32, A [H] f32)."""
    Bsz, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xin, z = split_last(dot(x, p["w_xz"]), cfg.d_inner)
    Bm, Cm = split_last(dot(x, p["w_bc"]), N)             # [B,S,N]
    v = dot(x, p["w_dt"]).float() + p["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))           # jax softplus
    A = -torch.exp(p["a_log"])                             # [H] negative
    return xin.reshape(Bsz, S, H, P), z, Bm, Cm, dt, A


def _gated_norm(y, xh, z, x, p):
    """D skip, the gate and the RMSNorm's normalization, in x's dtype."""
    Bsz, S, H, P = xh.shape
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(Bsz, S, H * P).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    yf = y.float()
    ms = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + 1e-6)).to(x.dtype)


def _epilogue(y, xh, z, x, p):
    """The gated RMSNorm (``_gated_norm`` times its weight), then the
    output projection."""
    return dot(_gated_norm(y, xh, z, x, p) * p["norm_w"], p["w_out"])


def ssm_forward(x, p, cfg: ModelConfig, *, state=None,
                impl: str = "naive"):
    """Mamba2 mixer.  x: [B, S, d].

    Training/prefill: state=None -> chunked SSD (``impl`` as in
    ``ssd_chunked``).  Decode: state = dict(ssm=[B,h,p,n]) -> single-step
    recurrence (S == 1).  Returns (y [B,S,d], new_state).
    """
    S = x.shape[1]
    xh, z, Bm, Cm, dt, A = _project(x, p, cfg)
    if state is None:
        chunk = min(cfg.ssm_chunk, S)
        ssd = ssd_on_shards if sh.is_dtensor(xh) else ssd_chunked
        y, final = ssd(xh, dt, A, Bm, Cm, chunk, impl=impl)
        new_state = {"ssm": final}
    else:
        step = recur if not sh.is_dtensor(state["ssm"]) else recur_on_shards
        y, s_new = step(state["ssm"], dt[:, 0], A, Bm[:, 0], xh[:, 0],
                        Cm[:, 0])
        y = y[:, None]                                     # [B,1,H,P]
        new_state = {"ssm": s_new}
    return _epilogue(y, xh, z, x, p), new_state


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """The decode state's shape (f32, the reference's
    ``ssm_state_spec``)."""
    return {"ssm": (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)}


def ssm_reference(x, p, cfg: ModelConfig):
    """Oracle: plain sequential recurrence (slow, small shapes only)."""
    Bsz, S, _ = x.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh, z, Bm, Cm, dt, A = _project(x, p, cfg)
    xf = xh.float()
    s = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])
        upd = Bm[:, t].float()[:, None, None, :] \
            * (dt[:, t, :, None] * xf[:, t])[..., None]
        s = s * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), s))
    y = torch.stack(ys, dim=1)                             # [B,S,H,P]
    return _epilogue(y, xh, z, x, p), {"ssm": s}
