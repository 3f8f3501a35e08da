"""Closed-loop memory traffic generator (replaces the open-loop Bernoulli
approximation for memory-bound workloads).

Every core issues read/write *transactions* against the in-package
stacks; each transaction is a request slot plus a pre-allocated,
service-gated reply slot (``memory.table``).  In flight, the engines cap
each core at ``dram.max_outstanding`` transactions — injection of a new
request is gated on the core's in-flight count, so offered traffic
responds to memory latency instead of being an open firehose: as load
approaches stack capacity, AMAT saturates and the cores self-throttle.

``load`` is the *demanded* data bandwidth in flits/cycle/core: each
transaction moves one ``pkt_flits`` data packet (the read reply, or the
write itself), so transaction birth events are Bernoulli at
``load / pkt_flits`` per cycle.  Deliveries below the demand mean the
point is past the memory-bound knee.

Address stream: per transaction a stack (uniform, or skewed onto stack 0
by ``hot_stack_frac``), a pseudo-channel, a bank and a row are drawn;
row reuse (and therefore the open-row hit rate) is controlled by the
size of the row space, ``dram.n_rows``.

A copy of ``repro.memory.closed_loop`` (the JAX package's module, which imports no JAX).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.memory.model import MEM_CH, DEFAULT_DRAM, DramTimingParams
from repro_torch.memory.table import MEM_READ, MEM_WRITE, MemTableBuilder, \
    mem_source_rows


@dataclasses.dataclass(frozen=True)
class MemSweepSpec:
    """Closed-loop memory traffic spec for ``sweep.SweepPoint(mem=...)``."""

    load: float                       # demanded data flits/cycle/core
    read_frac: float = 0.7
    hot_stack_frac: float = 0.0
    dram: DramTimingParams = DEFAULT_DRAM


def closed_loop_uniform(topo: Topology, load: float, cycles: int,
                        pkt_flits: int, dram: DramTimingParams = DEFAULT_DRAM,
                        read_frac: float = 0.7, hot_stack_frac: float = 0.0,
                        seed: int = 0) -> "TrafficTable":
    """Closed-loop uniform memory traffic at ``load`` data-flits/cycle/core.

    Reply slots are allocated in global birth order, so each (stack,
    channel) response queue's in-order injection tracks the expected
    request arrival order.
    """
    if not topo.n_mem:
        raise ValueError("closed-loop memory traffic needs memory stacks")
    rng = np.random.default_rng(seed)
    core_sw = np.nonzero(topo.is_core)[0].astype(np.int32)
    mem_sw = np.nonzero(topo.is_mem)[0].astype(np.int32)
    n = len(core_sw)
    p_req = min(1.0, load / pkt_flits)
    arr = rng.random((n, cycles)) < p_req
    # time-major nonzero => events come out in global birth order
    t_ev, c_ev = np.nonzero(arr.T)
    ne = len(t_ev)
    stacks = rng.integers(0, topo.n_mem, ne)
    if hot_stack_frac > 0.0:
        stacks = np.where(rng.random(ne) < hot_stack_frac, 0, stacks)
    reads = rng.random(ne) < read_frac
    chans = rng.integers(0, MEM_CH, ne)
    banks = rng.integers(0, dram.n_banks, ne)
    rows = rng.integers(0, dram.n_rows, ne)

    b = MemTableBuilder(mem_source_rows(core_sw, mem_sw), mem_sw,
                        pkt_flits, dram)
    for i in range(ne):
        core = int(c_ev[i])
        b.request(core, MEM_READ if reads[i] else MEM_WRITE,
                  int(stacks[i]), int(chans[i]), int(banks[i]),
                  int(rows[i]), reply_dest=int(core_sw[core]),
                  birth=int(t_ev[i]))
    return b.build(offered_load=p_req * pkt_flits)
