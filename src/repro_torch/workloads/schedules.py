"""Collective -> trace-phase expansion (ring / one-shot / hierarchical).

Lowers one logical collective over a device group into the phase-structured
message schedule a real runtime would execute, using the cost model of
``interconnect.scheduler`` to pick the schedule (the paper's architectural
choice — multi-hop neighbor exchange vs single-hop broadcast — replayed at
the collective-algorithm level):

  ring          bandwidth-optimal chains of neighbor exchanges: an
                all-reduce of B bytes over g devices is 2(g-1) dependent
                phases of g point-to-point messages of B/g bytes;
  oneshot       latency-optimal single logical hop: every device
                *multicasts* its payload to the rest of the group in one
                phase — the schedule a broadcast medium (the paper's
                mm-wave channel) makes cheap;
  hierarchical  the paper's WI-per-cluster pattern: ring reduce-scatter
                inside each chip (fast domain), a one-shot exchange among
                per-chip leaders (slow domain), ring all-gather back out.

Groups smaller than the device count expand as ``n_devices // g``
concurrent blocks sharing phases (parallel TP/DP groups in compiled HLO).

A copy of ``repro.workloads.schedules`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

from repro_torch.interconnect.scheduler import choose_schedule
from repro_torch.workloads.mapping import DeviceMap
from repro_torch.workloads.trace import TraceMessage, TracePhase

SCHEDULES = ("ring", "oneshot", "hierarchical", "auto")


def _blocks(n_devices: int, g: int, stride: int = 1) -> list[list[int]]:
    """Concurrent device groups of size g.

    ``stride=1``: contiguous blocks (block-to-chip mapping keeps the group
    intra-chip — TP style).  ``stride=s``: members s ranks apart within
    spans of ``s*g`` (one member per contiguous block — DP style, spanning
    chips), matching XLA's iota replica-group layouts.
    """
    g = max(2, min(g, n_devices))
    if stride <= 1:
        return [list(range(i, min(i + g, n_devices)))
                for i in range(0, n_devices - 1, g)]
    out = []
    for base in range(0, n_devices, stride * g):
        for r in range(stride):
            grp = [base + r + j * stride for j in range(g)
                   if base + r + j * stride < n_devices]
            if len(grp) > 1:
                out.append(grp)
    return out or [list(range(min(g, n_devices)))]


def _ring_phases(blocks, step_bytes: float, n_steps: int, label: str):
    """n_steps dependent phases; in each, every device sends step_bytes to
    its ring successor (all blocks advance concurrently)."""
    phases = []
    for _ in range(n_steps):
        msgs = []
        for grp in blocks:
            g = len(grp)
            msgs += [TraceMessage(grp[i], (grp[(i + 1) % g],), step_bytes)
                     for i in range(g)]
        phases.append(TracePhase(tuple(msgs), label=label))
    return phases


def _oneshot_phase(blocks, bytes_each: float, label: str):
    msgs = []
    for grp in blocks:
        for d in grp:
            msgs.append(TraceMessage(
                d, tuple(x for x in grp if x != d), bytes_each))
    return [TracePhase(tuple(msgs), label=label)]


def _alltoall_phase(blocks, bytes_pair: float, label: str):
    msgs = []
    for grp in blocks:
        for d in grp:
            msgs += [TraceMessage(d, (x,), bytes_pair)
                     for x in grp if x != d]
    return [TracePhase(tuple(msgs), label=label)]


def _hier_allreduce(blocks, payload: float, dm: DeviceMap, label: str):
    """Two-level all-reduce: intra-chip ring RS, one-shot leader exchange,
    intra-chip ring AG.  Falls back to a flat ring when a block does not
    span chips."""
    phases = []
    for grp in blocks:
        chips: dict[int, list[int]] = {}
        for d in grp:
            chips.setdefault(dm.node_chip(d), []).append(d)
        locals_ = [v for v in chips.values()]
        if len(locals_) < 2 or max(len(v) for v in locals_) < 2:
            phases += _ring_phases([grp], payload / len(grp),
                                   2 * (len(grp) - 1), label)
            continue
        gf = max(len(v) for v in locals_)
        # 1) reduce-scatter inside each chip
        phases += _ring_phases([v for v in locals_ if len(v) > 1],
                               payload / gf, gf - 1, label)
        # 2) leaders exchange their shard across chips in one shot
        leaders = [v[0] for v in locals_]
        phases += _oneshot_phase([leaders], payload / gf, label)
        # 3) all-gather inside each chip
        phases += _ring_phases([v for v in locals_ if len(v) > 1],
                               payload / gf, gf - 1, label)
    return phases


def pick_schedule(op: str, payload: float, group, dm: DeviceMap) -> str:
    """``choose_schedule`` cost model over the group's chip structure."""
    chips = {dm.node_chip(d) for d in group}
    g_slow = max(1, len(chips))
    g_fast = max(1, len(group) // g_slow)
    if g_slow == 1 or g_fast == 1:
        return choose_schedule(payload, len(group), 1)
    return choose_schedule(payload, g_fast, g_slow)


def expand_collective(op: str, payload: float, group_size: int,
                      dm: DeviceMap, schedule: str = "auto",
                      label: str = "", stride: int = 1) -> list[TracePhase]:
    """Expand one collective into trace phases.

    ``payload`` is the per-device vector size in bytes (all-gather: the
    gathered output per device).  Emits the standard wire-byte totals of
    ``interconnect.hlo_traffic``'s cost model for the matching schedule.
    """
    n = dm.n_devices
    if n < 2 or group_size < 2:
        return []
    blocks = _blocks(n, group_size, stride)
    label = label or op
    if op == "all-to-all":
        g = len(blocks[0])
        return _alltoall_phase(blocks, payload / g, label)
    if op == "collective-permute":
        return _ring_phases(blocks, payload, 1, label)

    if schedule == "auto":
        schedule = pick_schedule(op, payload, blocks[0], dm)

    g = len(blocks[0])
    if op == "all-reduce":
        if schedule == "oneshot":
            return _oneshot_phase(blocks, payload, label)
        if schedule == "hierarchical":
            return _hier_allreduce(blocks, payload, dm, label)
        return _ring_phases(blocks, payload / g, 2 * (g - 1), label)
    if op == "all-gather":
        if schedule == "oneshot":
            return _oneshot_phase(blocks, payload / g, label)
        return _ring_phases(blocks, payload / g, g - 1, label)
    if op == "reduce-scatter":
        # no broadcast advantage: every shard has a single consumer
        if schedule == "oneshot":
            return _alltoall_phase(blocks, payload / g, label)
        return _ring_phases(blocks, payload / g, g - 1, label)
    raise ValueError(f"unknown collective op {op!r}")
