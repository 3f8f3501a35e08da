"""Mixture-of-Experts feed-forward with top-k routing (Mixtral / DBRX).

Port of ``repro/models/moe.py``: sort-based capacity dispatch.  Each
token's (token, expert) assignments are sorted by expert (a stable sort of
the flat expert ids), each expert takes up to ``capacity`` of them in token
order (the overflow is dropped, standard capacity-factor semantics), the
expert FFNs run as batched matrix products over the expert axis, and the
results are combined back weighted by the router's gates.

Group-local dispatch, as the reference's: ``specs=(buf_spec, tok_spec,
G)`` splits the T tokens into ``G`` groups of ``T / G`` (one per data
shard); each group sorts and dispatches only its own tokens, into its own
expert buffer ``[G, E, cap_g, d]`` with ``cap_g`` the capacity of ``T / G``
tokens, and combines its own.  The buffer and the token view are pinned
to ``buf_spec`` and ``tok_spec`` with ``layers.constrain`` (identity on
plain tensors).  With no ``specs`` there is one group, ``G = 1``.

The dtypes follow the reference step for step: router logits in the
model's dtype, then f32; softmax, top-k and the renormalisation in f32;
the three expert products in the model's dtype; ``act(h_gate.f32)``
cast back before it gates ``h_in``; the gates cast to the model's dtype
before the combine.  Three points where torch differs from ``jnp`` and the
port writes out the reference's result:

- ``top_k``: ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order for ties.  Router logits are
  bf16 products, so equal probabilities at the top-k boundary are common.
  The port takes a stable descending sort.
- the drop slot: the reference writes a dropped assignment to row
  ``E * cap``, one past the buffer, and JAX drops the write
  (``mode="drop"``).  The port's buffer has one spare row that takes those
  writes and is sliced off; no real slot is ever written twice.
- the combine: the reference scatter-adds each token's k weighted expert
  outputs into zeros in the model's dtype (``.at[tok_of].add``), one
  rounding per add.  XLA:CPU applies a scatter's updates in order, which
  for one token is the order of its experts (the sorted order is by
  expert).  The port gathers each token's k contributions and adds them in
  that order, ascending expert id, one rounding per add: the same sums,
  without atomics, so the result does not depend on the device's
  scheduling.  For k = 2 the order cannot matter (0 + a + b is one
  rounding); for k = 4 (dbrx) it can.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import constrain, gated


def moe_shapes(cfg: ModelConfig) -> dict:
    """The layer's parameter shapes (the reference's ``moe_spec``)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {"router": (d, E), "w_in": (E, d, f), "w_gate": (E, d, f),
            "w_out": (E, f, d)}


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens in one group: the reference's
    Python float arithmetic, ``int(capacity_factor * T * k / E) + 1``."""
    return int(cfg.capacity_factor * tokens * cfg.top_k / cfg.n_experts) + 1


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order and their indices, the lower index first among equal
    values (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router of x [..., d]: (gates [..., k] f32, renormalised to sum 1;
    experts [..., k] int64, by descending probability)."""
    logits = (x @ router).float()
    e = torch.exp(logits - logits.amax(-1, keepdim=True))   # jax softmax
    probs = e / e.sum(-1, keepdim=True)
    vals, idx = top_k(probs, k)
    return vals / vals.sum(-1, keepdim=True), idx


class Plan(NamedTuple):
    """Where each (token, expert) assignment goes, in the sorted order of
    the flat assignments ``t * k + j`` of its group: ``order`` (flat index
    of each), ``expert`` (its expert), ``keep`` (within capacity),
    ``dest`` (its buffer row ``expert * cap + position`` in its group's
    buffer, or ``E * cap`` when dropped) and ``token`` (counted across the
    groups: group ``g``'s token ``t`` is ``g * Tg + t``).  Each field is
    [Tg * k] for one group given as [T, k], else [G, Tg * k]."""
    order: torch.Tensor
    expert: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    token: torch.Tensor


def dispatch_plan(experts: torch.Tensor, n_experts: int, cap: int) -> Plan:
    """The reference's dispatch of experts [T, k] (one group) or
    [G, Tg, k] (each group on its own): a stable argsort of the group's
    flat expert ids, each assignment's position in its expert's queue from
    ``searchsorted``, and the first ``cap`` of each queue kept."""
    Tg, k = experts.shape[-2:]
    flat = experts.reshape(-1, Tg * k)                         # [G, Tg*k]
    G, dev = flat.shape[0], flat.device
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = flat.gather(-1, order)
    run_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=dev).expand(
            G, n_experts).contiguous(), side="left")
    pos = torch.arange(Tg * k, device=dev) - run_start.gather(-1, sorted_e)
    keep = pos < cap
    dest = torch.where(keep, sorted_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    token = order // k + Tg * torch.arange(G, device=dev)[:, None]
    plan = Plan(order, sorted_e, keep, dest, token)
    return Plan(*(f[0] for f in plan)) if experts.ndim == 2 else plan


def dropped(plan: Plan) -> torch.Tensor:
    """The assignments a plan drops for capacity: [n, 2] int64 rows
    (token, expert), sorted."""
    pairs = torch.stack([plan.token[~plan.keep], plan.expert[~plan.keep]], 1)
    if not len(pairs):
        return pairs
    key = pairs[:, 0] * (int(plan.expert.max()) + 1) + pairs[:, 1]
    return pairs[torch.argsort(key)]


def moe_ff(x: torch.Tensor, p: dict, cfg: ModelConfig,
           specs=None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d].  ``specs=(buf_spec, tok_spec, G)``: G
    dispatch groups, the buffer [G, E, cap_g, d] and the token view
    [G, Tg, d] pinned to the two specs."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return moe_on_shards(x, p, cfg, specs)
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    buf_spec, tok_spec, G = specs if specs is not None else (None, None, 1)
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    xf = constrain(x.reshape(G, Tg, d), tok_spec)
    cap = capacity(cfg, Tg)
    gates, experts, plan, buf = _dispatch(xf, p["router"], cfg, cap)
    bufe = constrain(buf[:, :E * cap].view(G, E, cap, d), buf_spec)
    # the expert products over every group's rows of an expert
    rows = bufe.transpose(0, 1).reshape(E, G * cap, d)
    h_in = torch.bmm(rows, p["w_in"])
    h_gate = torch.bmm(rows, p["w_gate"])
    h = gated(cfg.act, h_gate, h_in)
    y_e = torch.bmm(h, p["w_out"]).view(E, G, cap, d).transpose(0, 1)
    y_e = constrain(y_e, buf_spec).reshape(G, E * cap, d)
    y = _combine_groups(y_e, gates, experts, plan, E, cap).view(G, Tg, d)
    return constrain(y, tok_spec).reshape(B, S, d)


def _dispatch(xf, router, cfg: ModelConfig, cap: int):
    """Route and dispatch the groups of xf [G, Tg, d]: (gates [G, Tg, k],
    experts, plan, the buffer [G, E * cap + 1, d], its last row the drop
    slot's)."""
    G, Tg, d = xf.shape
    gates, experts = route(xf, router, cfg.top_k)
    plan = dispatch_plan(experts, cfg.n_experts, cap)
    gidx = torch.arange(G, device=xf.device)[:, None]
    buf = xf.new_zeros((G, cfg.n_experts * cap + 1, d))
    buf[gidx, plan.dest] = xf.reshape(G * Tg, d)[plan.token]
    return gates, experts, plan, buf


def _combine_groups(y_e, gates, experts, plan, E: int, cap: int):
    """The groups' outputs [G * Tg, d] from their expert outputs y_e
    [G, E * cap, d]: each assignment's weighted expert output, in sorted
    order, summed per token (``combine``)."""
    G = y_e.shape[0]
    gidx = torch.arange(G, device=y_e.device)[:, None]
    gathered = y_e[gidx, plan.dest.clamp(max=E * cap - 1)]
    gathered = torch.where(plan.keep[..., None], gathered,
                           torch.zeros((), dtype=y_e.dtype,
                                       device=y_e.device))
    w = gates.reshape(G, -1).gather(-1, plan.order)
    return combine(gathered * w[..., None].to(y_e.dtype), plan, experts)


def moe_on_shards(x, p: dict, cfg: ModelConfig, specs=None):
    """``moe_ff`` of a DTensor x [B, S, d] whose rows are split over the
    data ranks: each rank routes, dispatches and combines its own groups
    (one group per data shard with ``specs``; with none, one group of
    every token, gathered on each rank), and the expert products run on
    the shards of the buffer, the experts' weights split as they are
    (``layers.dot``).  The sort, ``searchsorted`` and the scatter of the
    dispatch have no DTensor sharding rule; they are local to a group by
    design.  With one group every rank holds the whole buffer, and the
    products split the weights' dims as they are (GSPMD's choice for a
    few rows against large weights)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.layers import dot
    from repro_torch.sharding import specs as sh
    B, S, d = x.shape
    E = cfg.n_experts
    buf_spec, tok_spec, G = specs if specs is not None else (None, None, 1)
    T = B * S
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    mesh = x.device_mesh
    if G == 1:
        xf = x.redistribute(mesh, [Replicate()] * mesh.ndim) \
            .reshape(1, T, d)
    else:
        xf = constrain(x.reshape(G, Tg, d), tok_spec)
    split = [p_.is_shard(0) for p_ in xf.placements]
    if any(p_.is_shard() and not p_.is_shard(0) for p_ in xf.placements):
        raise ValueError(f"moe tokens placed {xf.placements}")
    xf = sh.with_placements(xf, lambda i, p_: p_ if split[i]
                            else Replicate())
    cap = capacity(cfg, Tg)
    groups = [Shard(0) if s else Replicate() for s in split]
    # the router's gradient on a rank covers its own groups' tokens only
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim) \
        .to_local(grad_placements=[Partial() if s else Replicate()
                                   for s in split])
    gates, experts, plan, buf = _dispatch(xf.to_local(), router, cfg, cap)
    bufe = sh.as_placed(buf[:, :E * cap].reshape(-1, E, cap, d), mesh,
                        groups, (G, E, cap, d))
    bufe = constrain(bufe, buf_spec)
    rows = bufe.transpose(0, 1).reshape(E, G * cap, d)
    h_in = dot(rows, p["w_in"])
    h_gate = dot(rows, p["w_gate"])
    h = gated(cfg.act, h_gate, h_in)
    y_e = dot(h, p["w_out"])
    y_e = sh.with_placements(y_e, lambda i, p_: Replicate()
                             if p_.is_partial() else p_)
    y_e = y_e.reshape(E, G, cap, d).transpose(0, 1)
    y_e = constrain(y_e, buf_spec)
    y_e = sh.with_placements(y_e, lambda i, p_: groups[i])
    y = _combine_groups(y_e.to_local().reshape(-1, E * cap, d), gates,
                        experts, plan, E, cap)
    y = sh.as_placed(y.reshape(-1, Tg, d), mesh, groups, (G, Tg, d))
    y = constrain(y, tok_spec).reshape(B, S, d)
    return sh.with_placements(y, lambda i, p_: Replicate()
                              if x.placements[i].is_partial()
                              else x.placements[i])


def combine(y_sorted: torch.Tensor, plan: Plan,
            experts: torch.Tensor) -> torch.Tensor:
    """Each token's k contributions (rows of ``y_sorted``, in the plan's
    sorted order) summed in ascending expert id, one rounding per add in
    ``y_sorted``'s dtype: the reference's ``zeros.at[token].add(y_sorted)``
    as XLA:CPU applies it, update by update.  One group: y_sorted
    [T * k, d], experts [T, k]; G groups: [G, Tg * k, d] and [G, Tg, k].
    -> [T, d]."""
    Tg, k = experts.shape[-2:]
    order = plan.order.reshape(-1, Tg * k)                     # [G, Tg*k]
    G, dev = order.shape[0], order.device
    slot = torch.empty_like(order)
    slot.scatter_(1, order, torch.arange(Tg * k, device=dev).expand(
        G, Tg * k).contiguous())
    at = slot.view(G, Tg, k).gather(-1, experts.reshape(G, Tg, k).argsort(-1))
    at = (at + Tg * k * torch.arange(G, device=dev)[:, None, None]
          ).reshape(G * Tg, k)
    ys = y_sorted.reshape(G * Tg * k, -1)
    y = ys[at[:, 0]]
    for j in range(1, k):
        y = y + ys[at[:, j]]
    return y


def moe_ff_dense_reference(x: torch.Tensor, p: dict,
                           cfg: ModelConfig) -> torch.Tensor:
    """Oracle: every expert computes every token; no capacity drops."""
    gate_vals, experts = route(x, p["router"], cfg.top_k)
    gates = torch.zeros(x.shape[:-1] + (cfg.n_experts,), dtype=torch.float32,
                        device=x.device).scatter(-1, experts, gate_vals)
    h_in = torch.einsum("bsd,edf->bsef", x, p["w_in"])
    h_gate = torch.einsum("bsd,edf->bsef", x, p["w_gate"])
    h = gated(cfg.act, h_gate, h_in)
    y = torch.einsum("bsef,efd->bsed", h, p["w_out"])
    return torch.einsum("bsed,bse->bsd", y, gates.to(x.dtype))
