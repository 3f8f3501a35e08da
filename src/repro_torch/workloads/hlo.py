"""Compiled-HLO -> trace compiler.

Takes the execution-ordered collective sequence of a compiled step
(``interconnect.hlo_traffic.collective_sequence``) and lowers every
collective through ``workloads.schedules`` into dependency-ordered message
phases on a concrete ``XCYM`` device mapping.  This is the bridge that runs
*real model steps* — not synthetic Bernoulli traffic — through the paper's
cycle-accurate engine.

Scaling knobs (big training steps move GBs per collective; the flit-level
simulator wants thousands, not billions, of packets):

  ``bytes_scale``       multiply all payload bytes before emission
                        (``core.traffic.from_trace`` floors each message at
                        one packet); per-*bit* metrics (pJ/bit) are scale-
                        invariant, which is what the analytic cross-check
                        against ``fabric.price_traffic`` uses.
  ``max_collectives``   truncate the sequence (a step's schedule repeats
                        per layer; a prefix is representative).
  ``fold_repeats``      a collective inside a scanned layer stack appears
                        once with ``repeat=n_layers``; fold the repeat into
                        payload bytes instead of emitting n_layers copies.

Residency: with ``residency=True`` each collective is preceded by a phase
of memory-stack reads (each participating device fetches its payload shard
from its resident stack) and followed by write-backs — the in-package
memory traffic of the paper's XCYM systems.

A copy of ``repro.workloads.hlo`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

from repro_torch.interconnect.hlo_traffic import (CollectiveCall,
                                            collective_sequence)
from repro_torch.workloads.mapping import DeviceMap
from repro_torch.workloads.schedules import expand_collective
from repro_torch.workloads.trace import (MEM_NODE, Trace, TraceMessage, TracePhase)

import numpy as np


def _residency_phases(dm: DeviceMap, bytes_each: float,
                      label: str, write: bool, closed: bool = False):
    """Stack <-> device residency traffic around one collective.

    Every device appears: the concurrent blocks of ``workloads.schedules``
    partition the whole device range, so each device fetches/writes its
    own payload shard regardless of the per-block group size.

    ``closed`` lowers the traffic as true round trips (``op="read"`` /
    ``op="write"`` messages — request, bank service, reply)
    instead of the legacy open-loop one-way pushes.
    """
    if dm.topo.n_mem == 0:
        return []
    msgs = []
    for d in range(dm.n_devices):
        stack = int(np.nonzero(dm.mem_switch == dm.dev_mem[d])[0][0])
        if closed:
            msgs.append(TraceMessage(d, (MEM_NODE(stack),), bytes_each,
                                     op="write" if write else "read"))
        else:
            pair = (d, MEM_NODE(stack)) if write else (MEM_NODE(stack), d)
            msgs.append(TraceMessage(pair[0], (pair[1],), bytes_each))
    tag = "wr" if write else "rd"
    return [TracePhase(tuple(msgs), label=f"{label}/{tag}")]


def trace_from_collectives(calls: list[CollectiveCall], dm: DeviceMap,
                           name: str, schedule: str = "auto",
                           bytes_scale: float = 1.0,
                           max_collectives: int | None = None,
                           fold_repeats: bool = True,
                           residency=False) -> Trace:
    """Lower an ordered collective list into a phase trace on ``dm``.

    ``residency`` may be ``False``, ``True`` (legacy open-loop one-way
    stack traffic) or ``"closed"`` (round-trip reads/write-acks through
    the stacks' bank model).
    """
    phases: list[TracePhase] = []
    closed = residency == "closed"
    used = 0
    for i, c in enumerate(calls):
        if max_collectives is not None and used >= max_collectives:
            break
        reps = 1 if fold_repeats else c.repeat
        payload = c.payload_bytes * bytes_scale * (c.repeat if fold_repeats
                                                   else 1)
        label = f"c{i}:{c.op}"
        for _ in range(reps):
            if residency:
                phases += _residency_phases(dm, payload, label, write=False,
                                            closed=closed)
            phases += expand_collective(c.op, payload, c.group_size, dm,
                                        schedule=schedule, label=label,
                                        stride=c.stride)
            if residency:
                phases += _residency_phases(dm, payload, label, write=True,
                                            closed=closed)
        used += 1
    return Trace(name=name, n_devices=dm.n_devices, phases=phases,
                 meta={"schedule": schedule, "bytes_scale": bytes_scale,
                       "source": "hlo", "n_collectives": used,
                       "residency": residency})


def trace_from_hlo(hlo: str, dm: DeviceMap, name: str,
                   schedule: str = "auto", bytes_scale: float = 1.0,
                   max_collectives: int | None = None,
                   residency=False) -> Trace:
    """Compile optimized-HLO text into a trace on device map ``dm``.

    The HLO's logical device count need not match ``dm.n_devices``: group
    sizes are clipped to the mapped system (a 256-way all-reduce becomes an
    all-reduce over every mapped device), preserving per-device payloads.
    """
    calls = [CollectiveCall(c.op, c.payload_bytes,
                            min(c.group_size, dm.n_devices), c.repeat,
                            stride=c.stride)
             for c in collective_sequence(hlo, dm.n_devices)]
    return trace_from_collectives(calls, dm, name, schedule=schedule,
                                  bytes_scale=bytes_scale,
                                  max_collectives=max_collectives,
                                  residency=residency)
