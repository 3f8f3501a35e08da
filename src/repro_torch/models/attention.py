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

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import constrain, rope

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
    for i in range(n_blocks):
        kblk = k[:, i * block:(i + 1) * block]
        vblk = v[:, i * block:(i + 1) * block]
        n = kblk.shape[1]                      # the last block may be short
        kpos = i * block + torch.arange(block, device=q.device)
        kr = _repeat_kv(kblk, g).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kr)
        if n < block:                          # the reference pads with 0
            s = torch.nn.functional.pad(s, (0, block - n))
        mask = kpos[None, :] <= qpos[:, None] if causal else \
            torch.ones((Sq, block), dtype=torch.bool, device=q.device)
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        mask &= (kpos < Sk)[None, :]
        s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        vr = _repeat_kv(vblk, g).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p[..., :n], vr)
        l = l * alpha + p.sum(-1)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)       # [B, Sq, H, hd]


def attention_inner(q, k, v, *, causal, window=0, impl: str = "blockwise"):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    return blockwise_attention(q, k, v, causal=causal, window=window)


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
    q = (x @ p["wq"]).reshape(B, -1, H, hd)
    k = (src @ p["wk"]).reshape(B, -1, Hkv, hd)
    v = (src @ p["wv"]).reshape(B, -1, Hkv, hd)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if x_kv is None:
            k = rope(k, positions, cfg.rope_theta)
    if sp_specs is not None and kv_cache is None:
        q = constrain(q, sp_specs[0])
        k = constrain(k, sp_specs[1])
        v = constrain(v, sp_specs[1])

    new_cache = None
    if kv_cache is not None:
        S = kv_cache["k"].shape[1]
        T = k.shape[1]
        start = min(max(int(cache_slot), 0), S - T)
        k_all, v_all = kv_cache["k"], kv_cache["v"]
        k_all[:, start:start + T] = k.to(k_all.dtype)
        v_all[:, start:start + T] = v.to(v_all.dtype)
        new_cache = {"k": k_all, "v": v_all}
        valid = torch.arange(S, device=x.device) < valid_len
        # grouped-head einsums: never materialize the repeated K/V
        g = H // Hkv
        qg = q.reshape(B, -1, Hkv, g, hd).float()
        scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k_all.float())
        scores = scores / math.sqrt(hd)
        scores = torch.where(valid[None, None, None, None], scores, NEG)
        pr = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgqs,bshd->bqhgd", pr, v_all.float())
        out = out.reshape(B, out.shape[1], H, hd).to(x.dtype)
    else:
        out = attention_inner(q, k, v, causal=causal,
                              window=cfg.sliding_window, impl=impl)
    y = out.reshape(B, out.shape[1], H * hd) @ p["wo"]
    return y, new_cache
