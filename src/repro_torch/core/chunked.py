"""Drain-aware chunked execution driver (port of ``repro.core.chunked``).

The driver steps all lanes of a batch in lockstep, ``CHUNK_CYCLES`` cycles
per chunk.  Between chunks a ``drain_done`` predicate asks, per lane,
whether the state can ever change again (no packet in any slot, empty
pipes, no injection burst, no future birth, all busy clocks expired, past
warm-up).  This is the driver's one host synchronisation per chunk.

Per-lane semantics are the reference's, where ``lax.map`` runs each lane's
``while_loop`` on its own:

- a lane keeps stepping while ``t0 < cycles`` and it has not drained at a
  chunk boundary ``t0``; the first boundary where that fails is its stop
  cycle, and from then on the lane is frozen by mask;
- inside a chunk each cycle is masked per lane by ``t < cycles`` (the
  reference's per-cycle ``lax.cond``), so a budget that ends mid-chunk
  freezes exactly there;
- ``_finalize`` adds the closed-form awake/sleep remainder for the cycles
  in ``[stop, cycles)`` and records ``cycles_run``/``drain_cycle``.

The loop ends when no lane steps any more.  Every lane's final state is
bitwise equal to a solo run of its point.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.traffic import NO_PKT

# Cycles per chunk (the reference's semantic constant).
CHUNK_CYCLES = 128


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[g, n, idx[g, n]]`` for ``a`` of shape [G, N, K]."""
    return torch.gather(a, 2, idx.long()[..., None])[..., 0]


def drain_done(ss, st, t0: int) -> torch.Tensor:
    """Per lane [G]: True iff no future cycle can change the state (except
    the awake/sleep accounting).  Open-loop tables only: ``rdy``/``dead``
    are placeholders and are not read."""
    G = st.pkt_src.shape[0]
    no_pkts = ~(st.pkt_src >= 0).reshape(G, -1).any(-1)
    pipes_empty = ~(st.pipe != 0).reshape(G, -1).any(-1)
    no_inj = ~(st.inj_vc >= 0).any(-1)
    K = ss.births.shape[2]
    qh = st.q_head.clamp(0, K - 1)
    open_slot = st.q_head < K
    idle_head = _take_rows(ss.births, qh) >= int(NO_PKT)
    no_births = (~open_slot | idle_head).all(-1)
    outst_zero = (st.outst == 0).all(-1)
    phases_done = (ss.n_phases == 0) | (st.cur_phase >= ss.n_phases)
    # busy receivers would keep the sleepy-rx accounting awake
    quiet = (st.busy_until <= t0).all(-1) & (st.wl_busy_until <= t0)
    return (no_pkts & pipes_empty & no_inj & no_births & outst_zero
            & phases_done & quiet & (ss.warmup <= t0))


def _finalize(ss, st, stop: torch.Tensor):
    """Close the books for cycles in [stop, cycles): awake/sleep remainder.

    After ``drain_done`` the only per-cycle accumulation left is the
    receiver wake/sleep accounting, all of it post-warmup.  Exact integer
    arithmetic.
    """
    cycles = ss.cycles
    rem = (cycles - stop).clamp(min=0).to(torch.int32)
    awake_pc = torch.where(ss.sleepy, 0, ss.n_wi).to(torch.int32)
    return st._replace(
        awake_cycles=st.awake_cycles + awake_pc * rem,
        sleep_cycles=st.sleep_cycles + (ss.n_wi - awake_pc) * rem,
        cycles_run=cycles.to(torch.int32),
        drain_cycle=torch.minimum(stop, cycles).to(torch.int32))


def _select(live: torch.Tensor, new, old):
    """Per-lane ``where(live, new, old)`` on every leaf that changed."""
    out = []
    for a, b in zip(new, old):
        if a is b:
            out.append(a)
        else:
            out.append(torch.where(live.view((-1,) + (1,) * (a.dim() - 1)),
                                   a, b))
    return type(old)(*out)


def run_chunked(step: Callable, ss, st, budgets: Sequence[int]):
    """Drive ``step(st, t) -> st`` over lane-leading ``st`` to each lane's
    budget, with early drain exit.

    ``budgets`` are the lanes' cycle budgets on the host (equal to
    ``ss.cycles``): where every lane is stepping and the whole chunk lies
    within every budget, no per-cycle mask is needed.
    """
    G = len(budgets)
    cycles = ss.cycles
    dev = cycles.device
    stopped = torch.zeros(G, dtype=torch.bool, device=dev)
    stop = torch.zeros(G, dtype=torch.int32, device=dev)
    t0 = 0
    while True:
        cont = ~stopped & (t0 < cycles) & ~drain_done(ss, st, t0)
        newly = ~stopped & ~cont
        stop = torch.where(newly, t0, stop)
        stopped = stopped | newly
        cont_h = cont.cpu()            # the one host sync per chunk
        if not bool(cont_h.any()):
            break
        unmasked = bool(cont_h.all()) and t0 + CHUNK_CYCLES <= min(budgets)
        for t in range(t0, t0 + CHUNK_CYCLES):
            new = step(st, t)
            st = new if unmasked else _select(cont & (t < cycles), new, st)
        t0 += CHUNK_CYCLES
    return _finalize(ss, st, stop)
