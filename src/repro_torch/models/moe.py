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
from repro_torch.models.layers import activation, constrain


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
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    buf_spec, tok_spec, G = specs if specs is not None else (None, None, 1)
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} groups")
    Tg = T // G
    xf = constrain(x.reshape(G, Tg, d), tok_spec)
    gates, experts = route(xf, p["router"], k)                 # [G, Tg, k]
    cap = capacity(cfg, Tg)
    plan = dispatch_plan(experts, E, cap)

    gidx = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros((G, E * cap + 1, d))       # + the drop slot's row
    buf[gidx, plan.dest] = xf.reshape(T, d)[plan.token]
    bufe = constrain(buf[:, :E * cap].view(G, E, cap, d), buf_spec)
    # the expert products over every group's rows of an expert
    rows = bufe.transpose(0, 1).reshape(E, G * cap, d)
    h_in = torch.bmm(rows, p["w_in"])
    h_gate = torch.bmm(rows, p["w_gate"])
    h = activation(cfg.act)(h_gate.float()).to(h_in.dtype) * h_in
    y_e = torch.bmm(h, p["w_out"]).view(E, G, cap, d).transpose(0, 1)
    y_e = constrain(y_e, buf_spec).reshape(G, E * cap, d)

    # combine: each assignment's weighted expert output, in sorted order
    gathered = y_e[gidx, plan.dest.clamp(max=E * cap - 1)]
    gathered = torch.where(plan.keep[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    w = gates.reshape(G, -1).gather(-1, plan.order)
    y_sorted = gathered * w[..., None].to(x.dtype)
    y = combine(y_sorted, plan, experts).view(G, Tg, d)
    return constrain(y, tok_spec).reshape(B, S, d)


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
    h = activation(cfg.act)(h_gate.float()).to(h_in.dtype) * h_in
    y = torch.einsum("bsef,efd->bsed", h, p["w_out"])
    return torch.einsum("bsed,bse->bsd", y, gates.to(x.dtype))
