"""Forwarding-table routing over pre-computed shortest paths (paper §III.C).

The paper routes every flow along shortest paths computed by Dijkstra's
algorithm, realized as per-switch forwarding tables consulted only for the
header flit (wormhole).  We compute all-pairs shortest paths with a
vectorized Floyd-Warshall (identical metric; verified against networkx
Dijkstra in tests) and derive, for every (switch, destination), the *output*
to take: a directed link id, or the ejection port when switch == destination.

Deterministic lowest-index tie-breaking makes each destination's routes an
in-tree (cycle-free per destination), which is the forwarding-table analogue
of the paper's loop-free shortest-path-tree argument.

Wireless pair-links participate in the metric with a configurable weight
(service time + amortized MAC wait), so "even intra-chip traffic uses the
wireless links if it reduces the path length" (§IV.C) falls out naturally.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.constants import LinkClass, PhyParams
from repro_torch.core.topology import Topology

INF = np.float64(1e18)


def link_weight(cls: np.ndarray, phy: PhyParams, wireless_weight: float) -> np.ndarray:
    """Routing weight per directed link: per-flit service cycles.

    MESH/INTERPOSER/WIDEIO forward one flit per cycle; SERIAL serializes at
    15 Gbps; the wireless hop gets `wireless_weight` (its service time plus a
    small amortized channel-arbitration cost).
    """
    w = np.ones(len(cls), np.float64)
    w[cls == LinkClass.SERIAL] = phy.serial_flit_cycles
    w[cls == LinkClass.INTERPOSER] = phy.interposer_flit_cycles
    w[cls == LinkClass.WIDEIO] = phy.wideio_flit_cycles
    w[cls == LinkClass.WIRELESS] = wireless_weight
    return w


@dataclasses.dataclass
class RoutingTables:
    dist: np.ndarray      # [S, S] shortest-path metric
    next_out: np.ndarray  # [S, S] output id: link id, or L + s (ejection) at dest
    n_outputs: int        # L_total (wired + wireless pair links) + S ejections
    weights: np.ndarray   # [L_total] per-link routing weight used


TRANSIT_FORBIDDEN = 1e6  # memory stacks are traffic sinks, never routers


def _all_links(topo: Topology, phy: PhyParams, wireless_weight: float):
    """Wired links + wireless pair-links as one directed edge list."""
    src = topo.link_src
    dst = topo.link_dst
    cls = topo.link_cls
    if topo.n_wi:
        wsrc = topo.wi_switch[topo.wl_pairs[:, 0]]
        wdst = topo.wi_switch[topo.wl_pairs[:, 1]]
        src = np.concatenate([src, wsrc])
        dst = np.concatenate([dst, wdst])
        cls = np.concatenate([cls, np.full(len(wsrc), int(LinkClass.WIRELESS), np.int32)])
    w = link_weight(cls, phy, wireless_weight)
    # never route *through* a memory stack's logic die (it has no router for
    # transit traffic; it only sinks packets)
    w = np.where(topo.is_mem[src], TRANSIT_FORBIDDEN, w)
    return src.astype(np.int64), dst.astype(np.int64), w


def compute_routing(topo: Topology, wireless_weight: float = 3.0) -> RoutingTables:
    S = topo.n_switches
    src, dst, w = _all_links(topo, topo.phy, wireless_weight)
    L = len(src)

    # adjacency with min edge weight (keep lowest link id for ties)
    dist = np.full((S, S), INF)
    np.fill_diagonal(dist, 0.0)
    # process links in reverse id order so earlier ids win exact ties
    for l in range(L - 1, -1, -1):
        if w[l] <= dist[src[l], dst[l]]:
            dist[src[l], dst[l]] = w[l]

    # vectorized Floyd-Warshall
    for k in range(S):
        cand = dist[:, k:k + 1] + dist[k:k + 1, :]
        np.minimum(dist, cand, out=dist)

    if np.any(dist >= INF):
        bad = np.argwhere(dist >= INF)[0]
        raise ValueError(f"disconnected topology {topo.name}: no path {bad}")

    # next_out[s, d] = argmin over outgoing links l at s of w[l] + dist[dst(l), d]
    next_out = np.full((S, S), -1, np.int64)
    np.fill_diagonal(next_out, 0)  # placeholder, fixed below
    # group outgoing links per switch, ordered by link id (tie-break)
    order = np.argsort(src, kind="stable")
    for s in range(S):
        ls = order[np.searchsorted(src[order], s):np.searchsorted(src[order], s + 1)]
        if len(ls) == 0:
            continue
        # cost[l, d]
        cost = w[ls][:, None] + dist[dst[ls]]           # [k, S]
        best = np.argmin(cost, axis=0)                  # first minimum = lowest id
        ok = np.isclose(cost[best, np.arange(S)], dist[s], rtol=0, atol=1e-9)
        nxt = ls[best]
        next_out[s] = np.where(ok, nxt, -1)
    for s in range(S):
        next_out[s, s] = L + s                          # ejection output

    # spread destinations across parallel duplicate links (same src, dst,
    # weight): deterministic per-destination round-robin
    from collections import defaultdict
    groups = defaultdict(list)
    for l in range(len(src)):
        groups[(int(src[l]), int(dst[l]), float(w[l]))].append(l)
    for key, ls in groups.items():
        if len(ls) < 2:
            continue
        ls = sorted(ls)
        sel = next_out[key[0]] == ls[0]
        idx = np.nonzero(sel)[0]
        for j, d in enumerate(idx):
            next_out[key[0], d] = ls[j % len(ls)]

    if np.any(next_out < 0):
        raise AssertionError("forwarding table has holes")
    return RoutingTables(dist=dist, next_out=next_out, n_outputs=L + S, weights=w)


def path_hops(rt: RoutingTables, topo: Topology, s: int, d: int) -> list[int]:
    """Reconstruct the link path s->d from the forwarding tables (for tests)."""
    src, dst, _ = _all_links(topo, topo.phy, 1.0)
    hops = []
    cur = s
    for _ in range(10_000):
        if cur == d:
            return hops
        l = rt.next_out[cur, d]
        assert l < len(src)
        hops.append(int(l))
        cur = int(dst[l])
    raise RuntimeError("routing loop")
