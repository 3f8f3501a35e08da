"""Construction of closed-loop traffic tables (request/reply slot pairing).

Closed-loop memory traffic is encoded the way trace tables encode phases —
fixed-shape and scan-friendly.  Every memory transaction occupies TWO
pre-allocated slots of the ``TrafficTable``:

- the *request* slot in the issuing core's source row: a read request
  (``MEM_READ``, short address packet) or a write (``MEM_WRITE``, full
  data packet), destined to a stack's base-logic-die switch and carrying
  the DRAM coordinates ``(channel, bank, row)``;
- the paired *reply* slot in the target stack's per-channel source row:
  read data (``MEM_RREPLY``, full data packet) or a short write ack
  (``MEM_WACK``), destined back to the requester.  Its birth is the
  sentinel ``NO_PKT`` — the engines gate it on delivery of the request
  plus the stack's bank-model service delay, computed in-engine from the
  per-stack per-channel/bank busy-until state (``memory.model``).

Reply slots live in one source row per (stack, pseudo-channel): the four
rows of a stack are its four return buses, each injecting at one
flit/cycle independently.  Within a channel row, replies inject in slot
order (an in-order per-channel response queue): a reply whose request
has not yet been serviced blocks later slots of the same channel —
allocation order is therefore chosen to track expected arrival order.

The request slot records the pair as ``(reply_row, reply_slot)`` —
deliberately NOT a flat index, so ``pack``'s K-padding cannot invalidate
it — and the reply slot records ``req_src`` (whose ``max_outstanding``
window to credit on delivery) and ``req_birth`` (the request's birth
cycle, the AMAT epoch).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.traffic import NO_PKT, TrafficTable
from repro_torch.memory.model import MEM_CH, DramTimingParams

# mem_op slot codes (0 = not a memory operation)
MEM_NONE = 0
MEM_READ = 1      # read request: core -> stack, short address packet
MEM_WRITE = 2     # write request: core -> stack, full data packet
MEM_RREPLY = 3    # read reply: stack -> core, full data packet
MEM_WACK = 4      # write ack: stack -> core, short packet


class MemTableBuilder:
    """Accumulate per-source packet slots, then build a ``TrafficTable``.

    ``src_switch`` lists every source row's switch: the issuing cores
    (or logical devices) first, then one row per (stack, channel) given
    by ``mem_row_of(stack, channel)``.  ``stack_switch[y]`` is stack
    ``y``'s base-logic-die switch (request destination).
    """

    def __init__(self, src_switch: np.ndarray, stack_switch: np.ndarray,
                 pkt_flits: int, dram: DramTimingParams,
                 mem_row_of=None):
        self.src_switch = np.asarray(src_switch, np.int32)
        self.stack_switch = np.asarray(stack_switch, np.int32)
        self.pkt_flits = int(pkt_flits)
        self.dram = dram
        n_core = len(self.src_switch) - len(self.stack_switch) * MEM_CH
        self._row_of = mem_row_of or (
            lambda y, ch: n_core + y * MEM_CH + ch)
        self.rows: list[list[tuple]] = [[] for _ in self.src_switch]
        self.n_mem_ops = 0

    # slot tuple: (birth, dest, phase, length, op, ch, bank, row,
    #              reply_row, reply_slot, req_src, req_birth)
    def plain(self, row: int, dest: int, *, birth: int = 0, phase: int = 0,
              length: int | None = None) -> None:
        """An ordinary (non-memory) packet slot; ``dest`` may be a
        multicast code ``-(1 + m)`` as in ``traffic.from_trace``."""
        self.rows[row].append(
            (birth, dest, phase, length or self.pkt_flits,
             MEM_NONE, 0, 0, 0, -1, -1, -1, NO_PKT))

    def request(self, row: int, op: int, stack: int, ch: int, bank: int,
                dram_row: int, *, reply_dest: int, birth: int = 0,
                phase: int = 0, data_flits: int | None = None) -> None:
        """One memory transaction: request slot + gated reply slot."""
        assert op in (MEM_READ, MEM_WRITE)
        assert 0 <= ch < MEM_CH
        data = data_flits or self.pkt_flits
        req_len = self.dram.req_flits if op == MEM_READ else data
        rep_len = data if op == MEM_READ else self.dram.ack_flits
        rep_op = MEM_RREPLY if op == MEM_READ else MEM_WACK
        rrow = self._row_of(stack, ch)
        rslot = len(self.rows[rrow])
        self.rows[rrow].append(
            (NO_PKT, reply_dest, phase, rep_len,
             rep_op, ch, bank, dram_row, -1, -1, row, birth))
        self.rows[row].append(
            (birth, int(self.stack_switch[stack]), phase, req_len,
             op, ch, bank, dram_row, rrow, rslot, -1, NO_PKT))
        self.n_mem_ops += 1

    def build(self, offered_load: float, *, phase_need=None,
              phase_labels=None, mc_member=None, mc_dst=None,
              mc_route=None) -> TrafficTable:
        n = len(self.rows)
        K = max(1, max((len(r) for r in self.rows), default=1))
        cols = [np.full((n, K), fill, np.int32) for fill in
                (NO_PKT, 0, 0, self.pkt_flits, MEM_NONE, 0, 0, 0,
                 -1, -1, -1, NO_PKT)]
        for i, slots in enumerate(self.rows):
            for k, rec in enumerate(slots):
                for c, v in zip(cols, rec):
                    c[i, k] = v
        (births, dests, phases, lens, op, ch, bank, row,
         reply_row, reply_slot, req_src, req_birth) = cols
        has_mem = self.n_mem_ops > 0
        return TrafficTable(
            src_switch=self.src_switch, births=births, dests=dests,
            offered_load=offered_load,
            phases=phases if phase_need is not None else None,
            phase_need=phase_need, mc_member=mc_member, mc_dst=mc_dst,
            mc_route=mc_route, phase_labels=phase_labels,
            lens=lens if has_mem else None,
            mem_op=op if has_mem else None,
            mem_ch=ch if has_mem else None,
            mem_bank=bank if has_mem else None,
            mem_row=row if has_mem else None,
            reply_row=reply_row if has_mem else None,
            reply_slot=reply_slot if has_mem else None,
            req_src=req_src if has_mem else None,
            req_birth=req_birth if has_mem else None,
            dram=self.dram if has_mem else None)


def mem_source_rows(core_switch: np.ndarray,
                    stack_switch: np.ndarray) -> np.ndarray:
    """Canonical closed-loop source layout: cores, then (stack, channel)
    reply rows — stack-major, channel-minor."""
    return np.concatenate([
        np.asarray(core_switch, np.int32),
        np.repeat(np.asarray(stack_switch, np.int32), MEM_CH)])
