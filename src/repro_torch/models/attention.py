"""Attention: GQA/MQA with RoPE, sliding windows, KV-cache decode.

Port of ``repro/models/attention.py``.  Three interchangeable inner
products, the reference's three ``impl`` names:
  - ``naive``     O(S^2) materialized scores — the oracle, small shapes only.
  - ``blockwise`` flash-style streaming softmax in plain torch (a Python loop
                  over KV blocks); memory O(S * block).
  - ``pallas``    the hand-written CUDA flash-attention kernel
                  (``kernels/csrc/flash_attention.cu`` through
                  ``kernels.ops.flash_attention``).  The name is the
                  reference's; on a CPU tensor the kernel's wrapper takes its
                  plain version.
``sp_specs`` (sequence-parallel attention) pins q, k and v to their specs
with ``layers.constrain``: a no-op on plain tensors, a redistribute on
DTensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import constrain, dot, rope, split_heads
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import P

NEG = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return k.repeat_interleave(groups, dim=2)


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k,v: [B,Sk,Hkv,hd]. Oracle implementation."""
    _, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores, NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_offset: int = 0, block: int = 1024
                        ) -> torch.Tensor:
    """Streaming-softmax attention: O(Sq * block) live memory.

    Walks the KV blocks keeping a running (max, denominator, accumulator)
    per query — the flash-attention recurrence, in plain torch.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    block = min(block, Sk)
    n_blocks = (Sk + block - 1) // block
    qf = q.float() / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device) + q_offset

    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)

    def body(m, l, acc, kblk, vblk, i: int):
        kpos = i * block + torch.arange(block, device=q.device)
        kr = _repeat_kv(kblk, g).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
        mask = kpos[None, :] <= qpos[:, None] if causal else \
            torch.ones((Sq, block), dtype=torch.bool, device=q.device)
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        mask &= (kpos < Sk)[None, :]
        s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        vr = _repeat_kv(vblk, g).float()
        # the product with v last: it saves the last tensors a checkpoint's
        # recompute needs, so the recompute stops before it runs (as the
        # reference's ``jax.checkpoint`` recomputes only p for the VJP)
        return m_new, l, acc + torch.einsum("bhqk,bkhd->bhqd", p, vr)

    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # flash semantics, as the reference's ``jax.checkpoint(body)``: the
        # backward recomputes each block's probabilities rather than
        # keeping O(Sq * Sk) of them
        step = body
        body = lambda *a: _ckpt.checkpoint(step, *a,        # noqa: E731
                                           use_reentrant=False)
    pad = n_blocks * block - Sk
    if pad:                                    # the reference pads with 0
        k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                for t in (k, v))
    for i in range(n_blocks):
        m, l, acc = body(m, l, acc, k[:, i * block:(i + 1) * block],
                         v[:, i * block:(i + 1) * block], i)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)       # [B, Sq, H, hd]


def attention_inner(q, k, v, *, causal, window=0, q_offset=0,
                    impl: str = "blockwise", block: int = 1024):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, block=block)


def inner_on_shards(q, k, v, *, causal, window=0, impl="blockwise"):
    """``attention_inner`` of DTensors, each rank on its own shard: the
    batch and heads of q as they are sharded, q's sequence too (the
    sequence-parallel attention of ``sp_specs``, its first row passed as
    ``q_offset``), k and v gathered to every key of the rank's rows and
    heads.  DTensor has no sharding rule for the einsums over a batch and
    heads sharded on two mesh dims; the product is local to a (row,
    head) block, as GSPMD partitions it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    H = q.shape[2]
    # a pending sum (the projection of a width-split x) reduced first
    q = sh.with_placements(q, lambda i, p: Replicate() if p.is_shard(3)
                           or p.is_partial() else p)
    pl = q.placements
    kv = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    # each rank's k and v gradients cover its own rows and heads of q only
    gkv = [Shard(0) if p.is_shard(0) else Partial() if p.is_shard()
           else Replicate() for p in pl]
    ql = q.to_local()
    kl, vl = (t.redistribute(q.device_mesh, kv).to_local(
        grad_placements=gkv) for t in (k, v))
    if ql.shape[2] != H:                  # this rank's heads of q
        h0, n = sh.shard_offset(q, 2), ql.shape[2]
        g = H // kl.shape[2]
        kl = _repeat_kv(kl, g)[:, :, h0:h0 + n]
        vl = _repeat_kv(vl, g)[:, :, h0:h0 + n]
    out = attention_inner(ql, kl, vl, causal=causal, window=window,
                          q_offset=sh.shard_offset(q, 1), impl=impl)
    return sh.as_placed(out, q.device_mesh, pl, q.shape)


# decode's two products against a cache [B, S, Hkv, hd] split on its
# batch (0), sequence (1) or head dim (3): per cache placement, the
# placements of the other operand and of the result
_CACHE_EINSUMS = {
    "bqhgd,bshd->bhgqs": {0: (0, 0), 1: (None, 4), 3: (4, "partial")},
    "bhgqs,bshd->bqhgd": {0: (0, 0), 1: (4, "partial"), 3: (None, 4)},
}


def _einsum_on_cache(eq, a, cache):
    """Decode's einsum ``eq`` of an operand a and a DTensor cache, each
    rank on its own shard of the cache (its rows, keys or head dims, as
    the cache is split): DTensor's own rule for the product may gather
    the cache."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rule = _CACHE_EINSUMS[eq]
    mesh, ap, op = cache.device_mesh, [], []
    for c in cache.placements:
        other, res = rule.get(c.dim, (None, None)) if c.is_shard() \
            else (None, None)
        ap.append(Replicate() if other is None else Shard(other))
        op.append(Replicate() if res is None else Partial()
                  if res == "partial" else Shard(res))
    a = a.redistribute(mesh, ap)
    out = torch.einsum(eq, a.to_local(), cache.to_local())
    lhs, rhs = eq.split("->")
    dims = dict(zip(lhs.split(",")[0], a.shape))
    dims.update(zip(lhs.split(",")[1], cache.shape))
    return sh.as_placed(out, mesh, op, tuple(dims[c] for c in rhs))


def write_cache(cache: torch.Tensor, new: torch.Tensor, start) -> None:
    """``cache[:, start:start + T] = new`` in place (cache [B, S, Hkv, hd],
    new [B, T, Hkv, hd]; ``start`` an int or a 0-d int tensor).  A DTensor
    cache takes a 0-d DTensor ``start``, the reference's traced position,
    and is written with no host read: on the sequence's shards (decode's
    ``seq_shard_decode``) each rank writes the one row that falls in its
    shard, if any."""
    T = new.shape[1]
    new = new.to(cache.dtype)
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(cache, DTensor):
        start = int(start)
        cache[:, start:start + T] = new
        return
    if T != 1:
        raise NotImplementedError("a sharded cache takes one row a step")
    mesh, pl = cache.device_mesh, cache.placements
    new = new.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                                  for p in pl])
    local, new = cache.to_local(), new.to_local()
    if isinstance(start, DTensor):
        start = start.full_tensor()
    # the first global row of this rank's shard of the sequence
    coord, n_loc, offset, span = mesh.get_coordinate(), local.shape[1], 0, 1
    for i in reversed(range(mesh.ndim)):
        if pl[i].is_shard(1):
            offset += coord[i] * span
            span *= mesh.size(i)
    row = start.long().reshape(1) - offset * n_loc
    mine = (row >= 0) & (row < n_loc)
    row = row.clamp(0, n_loc - 1)
    cur = local.index_select(1, row)
    local.index_copy_(1, row, torch.where(mine[:, None, None], new, cur))


def attn_shapes(d: int, H: int, Hkv: int, hd: int) -> dict:
    return {"wq": (d, H * hd), "wk": (d, Hkv * hd), "wv": (d, Hkv * hd),
            "wo": (H * hd, d)}


def attention(x, p, cfg, *, positions, causal=True, impl="blockwise",
              kv_cache: Optional[dict] = None, cache_slot=None,
              valid_len=None, x_kv=None, use_rope=True, sp_specs=None):
    """Full attention block.

    Decode mode (``kv_cache`` given): writes this step's roped k/v into
    cache slot ``cache_slot`` (ring-buffer slot for sliding-window archs)
    and attends over the first ``valid_len`` slots.  The slot is clamped so
    the write fits, as ``lax.dynamic_update_slice`` clamps it.  Unlike the
    reference, which returns new arrays, the write goes into ``kv_cache``'s
    tensors in place (a copy of a full-size cache per layer and step would
    cost more than the step); the returned cache holds those tensors.

    ``x_kv`` makes it cross-attention: k and v are projected from ``x_kv``
    (the encoder's output), and only q is roped.  ``use_rope=False`` ropes
    neither.  ``sp_specs`` ``(q_spec, kv_spec)``: outside decode, q, k and
    v are pinned to them (the reference's sequence-parallel attention:
    q's sequence over "model" where the head count does not divide it)."""
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if x_kv is None else x_kv
    if sp_specs is not None and kv_cache is None:
        # the projections on rows split as q's sequence is (GSPMD carries
        # the pin back to them), q pinned as [B, S, heads * hd]: the same
        # layout, and a sequence shard keeps whole heads
        x = constrain(x, P(*sp_specs[0][:3]))
        src = constrain(src, P(*sp_specs[0][:3]))
    q, k, v = dot(x, p["wq"]), dot(src, p["wk"]), dot(src, p["wv"])
    if sp_specs is not None and kv_cache is None:
        q = constrain(q, P(*sp_specs[0][:3]))
        k = constrain(k, P(*sp_specs[1][:3]))
        v = constrain(v, P(*sp_specs[1][:3]))
    q = split_heads(q, H, hd)
    k = split_heads(k, Hkv, hd)
    v = split_heads(v, Hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if x_kv is None:
            k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    if kv_cache is not None:
        S = kv_cache["k"].shape[1]
        T = k.shape[1]
        if isinstance(cache_slot, torch.Tensor):
            start = cache_slot.clamp(0, S - T)
        else:
            start = min(max(int(cache_slot), 0), S - T)
        k_all, v_all = kv_cache["k"], kv_cache["v"]
        write_cache(k_all, k, start)
        write_cache(v_all, v, start)
        new_cache = {"k": k_all, "v": v_all}
        valid = torch.arange(S, device=x.device) < valid_len
        # grouped-head einsums: never materialize the repeated K/V
        g = H // Hkv
        ein = torch.einsum
        from torch.distributed.tensor import Replicate
        if sh.is_dtensor(k_all):               # q's heads whole, for groups
            ein = _einsum_on_cache
            q = sh.with_placements(q, lambda i, p: Replicate()
                                   if p.is_shard(2) else p)
        qg = q.reshape(B, -1, Hkv, g, hd).float()
        scores = ein("bqhgd,bshd->bhgqs", qg, k_all.float())
        scores = scores / math.sqrt(hd)
        scores = torch.where(valid[None, None, None, None], scores, NEG)
        pr = torch.softmax(scores, dim=-1)
        out = ein("bhgqs,bshd->bqhgd", pr, v_all.float())
        if sh.is_dtensor(out):                 # hd whole, to merge the heads
            out = sh.with_placements(out, lambda i, p: Replicate()
                                     if p.is_shard(4) else p)
        out = out.reshape(B, out.shape[1], H, hd).to(x.dtype)
    else:
        inner = attention_inner if not sh.is_dtensor(q) else inner_on_shards
        out = inner(q, k, v, causal=causal, window=cfg.sliding_window,
                    impl=impl)
    y = dot(out.reshape(B, out.shape[1], H * hd), p["wo"])
    return y, new_cache
