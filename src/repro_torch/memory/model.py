"""DRAM-stack timing model (per-stack pseudo-channels, banks, row buffers).

The in-package memory stacks of the paper (§III.A, §IV.A) are 4-channel
DRAM stacks with a base logic die.  This module defines the timing
parameters and a *host-side reference implementation* of the bank model
that both cycle-accurate engines embed (``core/simulator.py`` in
candidate-table/gather style, ``core/simulator_ref.py`` in
scatter/segment style):

- each stack exposes ``MEM_CH`` = 4 pseudo-channels, matching the four
  parallel ejection ways its base-logic-die switch already has;
- each pseudo-channel owns ``n_banks`` independent banks with a single
  open row each (``bank_row``) and a busy-until cycle (``bank_busy``);
- a request that ejects (tail flit) at the stack on cycle ``t`` starts
  service at ``max(t + 1, bank_busy)`` and completes after
  ``t_row_hit`` cycles if it hits the open row, else ``t_row_miss``
  (precharge + activate + CAS); the bank's open row becomes the
  request's row and its busy-until the completion cycle;
- the completion cycle is the cycle the paired *reply* packet (read
  data, or a short write ack) becomes eligible for injection at the
  stack's per-channel source row (see ``memory.table``).

Ejection-way arbitration guarantees at most one request enters a given
(stack, channel) per cycle, so the model needs no intra-cycle ordering;
channels and banks are fully independent.

``service`` below is the executable specification: the hypothesis
property tests (tests/test_memory.py) pin its invariants (no completion
before arrival + minimum service latency, per-bank busy-until
monotonicity, per-bank service order = arrival order), and the
differential engine tests pin that both engines realize the same
dynamics.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Pseudo-channels per stack.  Fixed at 4 to match the simulators'
# EJ_WAYS parallel ejection channels at memory-stack switches (§IV).
MEM_CH = 4


@dataclasses.dataclass(frozen=True)
class DramTimingParams:
    """Timing/geometry of one in-package DRAM stack (per pseudo-channel).

    Cycle values are core-clock cycles (2.5 GHz => 0.4 ns).  Defaults are
    HMC-class in-package figures: ~12 ns open-row access, ~30 ns
    precharge + activate + CAS on a row miss.
    """

    n_banks: int = 8          # banks per pseudo-channel
    n_rows: int = 16          # row-address space the generators draw from
    t_row_hit: int = 30       # cycles: CAS + burst on the open row
    t_row_miss: int = 75      # cycles: PRE + ACT + CAS + burst
    req_flits: int = 4        # read-request (address) packet length, flits
    ack_flits: int = 2        # write-ack packet length, flits
    max_outstanding: int = 8  # per-core in-flight memory transaction cap


DEFAULT_DRAM = DramTimingParams()


def service(arrivals: np.ndarray, dram: DramTimingParams = DEFAULT_DRAM):
    """Reference bank model for ONE stack: service a request sequence.

    ``arrivals`` is ``[n, 4]`` int — rows of ``(cycle, channel, bank,
    row)`` in arrival order (the order requests eject at the stack; the
    engines produce at most one arrival per (channel, cycle)).

    Returns ``(start, done, hit)`` arrays: service-start cycle,
    completion cycle (= reply birth), and row-hit flag per request.
    """
    arrivals = np.asarray(arrivals)
    n = len(arrivals)
    busy = np.zeros((MEM_CH, dram.n_banks), np.int64)
    open_row = np.full((MEM_CH, dram.n_banks), -1, np.int64)
    start = np.zeros(n, np.int64)
    done = np.zeros(n, np.int64)
    hit = np.zeros(n, bool)
    for i, (t, ch, bank, row) in enumerate(arrivals):
        hit[i] = open_row[ch, bank] == row
        svc = dram.t_row_hit if hit[i] else dram.t_row_miss
        start[i] = max(int(t) + 1, int(busy[ch, bank]))
        done[i] = start[i] + svc
        busy[ch, bank] = done[i]
        open_row[ch, bank] = row
    return start, done, hit
