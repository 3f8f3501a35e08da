"""In-package memory subsystem: DRAM-stack timing + closed-loop traffic.

- ``memory.model``: per-stack pseudo-channel/bank timing parameters and
  the host-side reference bank model the cycle step embeds.
- ``memory.table``: request/reply slot pairing — the fixed-shape
  closed-loop encoding of the ``TrafficTable``.
- ``memory.closed_loop``: the closed-loop generator (per-core
  ``max_outstanding`` miss cap, read/write mixes, hot stacks).

Copies of the modules of ``repro.memory`` (numpy).
"""
from repro_torch.memory.closed_loop import MemSweepSpec, closed_loop_uniform
from repro_torch.memory.model import (DEFAULT_DRAM, MEM_CH, DramTimingParams,
                                      service)
from repro_torch.memory.table import (MEM_NONE, MEM_READ, MEM_RREPLY,
                                      MEM_WACK, MEM_WRITE, MemTableBuilder,
                                      mem_source_rows)

__all__ = [
    "DEFAULT_DRAM", "MEM_CH", "DramTimingParams", "service",
    "MEM_NONE", "MEM_READ", "MEM_RREPLY", "MEM_WACK", "MEM_WRITE",
    "MemTableBuilder", "mem_source_rows", "closed_loop_uniform",
    "MemSweepSpec",
]
