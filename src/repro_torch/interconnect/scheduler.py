"""Collective-schedule selection — the paper's architectural insight applied
to mesh collectives.

WiMCS replaces multi-hop wireline paths with single-hop broadcast links and
arbitrates them with a cheap control-packet schedule.  On a TPU torus the
same *choice* appears as: ring schedules (neighbor exchanges, bandwidth-
optimal, latency O(g)) vs one-shot/broadcast schedules (single logical hop,
latency-optimal, bandwidth O(g * bytes)) vs hierarchical two-level schedules
(the paper's WI-per-cluster pattern: reduce inside the fast domain, exchange
one stream across the slow domain).

The cost functions and ``choose_schedule`` of
``repro.interconnect.scheduler``, copied; its two-level schedule
(``hierarchical_psum``, ``hierarchical_grad_reduce``) as
``torch.distributed`` all-reduces over a ``DeviceMesh``'s axis groups.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkModel:
    bw: float          # bytes/s per link
    latency_s: float   # per message


ICI = LinkModel(bw=50e9, latency_s=1e-6)
DCN = LinkModel(bw=12.5e9, latency_s=10e-6)


def ring_cost(bytes_: float, g: int, link: LinkModel) -> float:
    return 2 * (g - 1) / g * bytes_ / link.bw + 2 * (g - 1) * link.latency_s


def oneshot_cost(bytes_: float, g: int, link: LinkModel) -> float:
    # every node broadcasts its full vector and locally reduces the g-1 it
    # receives: single logical hop (latency-optimal, bandwidth-hungry) —
    # the wireless-medium analogue
    return (g - 1) * bytes_ / link.bw + link.latency_s


def hierarchical_cost(bytes_: float, g_fast: int, g_slow: int,
                      fast: LinkModel = ICI, slow: LinkModel = DCN) -> float:
    # reduce-scatter+all-gather inside the fast domain, one exchange across
    return ring_cost(bytes_, g_fast, fast) \
        + ring_cost(bytes_ / g_fast, g_slow, slow)


def choose_schedule(bytes_: float, g_fast: int, g_slow: int = 1) -> str:
    """Pick the schedule the WiMCS cost model prefers for an all-reduce."""
    flat = ring_cost(bytes_, g_fast * g_slow, ICI if g_slow == 1 else DCN)
    ones = oneshot_cost(bytes_, g_fast * g_slow,
                        ICI if g_slow == 1 else DCN)
    hier = hierarchical_cost(bytes_, g_fast, g_slow) if g_slow > 1 else flat
    costs = {"ring": flat, "oneshot": ones, "hierarchical": hier}
    return min(costs, key=costs.get)


# ---- the two-level (pod-aware) schedule over a DeviceMesh ----------------

def psum(x, axes, *, mesh):
    """The sum of ``x`` over this rank's groups along ``axes`` of
    ``mesh``, the last axis first, as a new tensor (``x`` is left as it
    was)."""
    import torch.distributed as dist
    out = x.clone()
    for a in reversed(tuple(axes)):
        dist.all_reduce(out, group=mesh.get_group(a))
    return out


def hierarchical_psum(x, fast_axis: str, slow_axis: str, *, mesh):
    """Two-level all-reduce: a sum over this rank's group along
    ``fast_axis`` (inside the pod), then along ``slow_axis`` (across
    pods).  Equivalent to one sum over both axes, but keeps the slow-axis
    message count at one stream per pod pair — the WI-per-cluster
    pattern."""
    return psum(x, (slow_axis, fast_axis), mesh=mesh)


def hierarchical_grad_reduce(grads, fast_axis: str = "data",
                             slow_axis: str = "pod", *, mesh):
    """``hierarchical_psum`` of every leaf of a (nested dict) tree."""
    if isinstance(grads, dict):
        return {k: hierarchical_grad_reduce(v, fast_axis, slow_axis,
                                            mesh=mesh)
                for k, v in grads.items()}
    return hierarchical_psum(grads, fast_axis, slow_axis, mesh=mesh)
