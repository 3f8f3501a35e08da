"""Drain-aware chunked execution driver (port of ``repro.core.chunked``).

The driver steps all lanes of a batch in lockstep, ``chunk`` cycles per
chunk.  Between chunks a ``drain_done`` predicate asks, per lane,
whether the state can ever change again (no packet in any slot, empty
pipes, no injection burst, no future birth, all busy clocks expired, past
warm-up).  This is the driver's one host synchronisation per chunk.

Two cycle counts are kept apart, as in the reference:

- ``chunk`` is the *execution* chunk: how many cycles run between drain
  checks (and host syncs).  Any positive value gives the same state in
  every leaf but ``drain_cycle``, which records the chunk boundary where
  a lane stopped.  It defaults to ``CHUNK_CYCLES``.
- ``CHUNK_CYCLES`` is the living channel's *window cadence*: the step
  applies the window update at every ``t % CHUNK_CYCLES == 0`` whatever
  the chunk, so chunked runs of any chunk size and the monolithic oracle
  agree on when the channel moves.

Per-lane semantics are the reference's, where ``lax.map`` runs each lane's
``while_loop`` on its own:

- a lane keeps stepping while ``t0 < cycles`` and it has not drained at
  an execution-chunk boundary ``t0``; the first boundary where that
  fails is its stop cycle, and from then on the lane is frozen by mask;
- inside a chunk each cycle is masked per lane by ``t < cycles`` (the
  reference's per-cycle ``lax.cond``), so a budget that ends mid-chunk
  freezes exactly there;
- ``_finalize`` adds the closed-form awake/sleep remainder for the cycles
  in ``[stop, cycles)`` and records ``cycles_run``/``drain_cycle``;
- a living-channel lane that drained early replays the window boundaries
  in ``[stop, cycles)`` that it skipped (``replay_windows``), as the
  reference does after its loop.  A frozen lane also misses the
  boundaries other lanes still step through, so the replay masks lanes by
  their own range rather than running once after the loop for all.

The loop ends when no lane steps any more.  Every lane's final state is
bitwise equal to a solo run of its point.
"""
from __future__ import annotations

import numbers
from typing import Callable, Sequence

import torch

from repro_torch.core.traffic import NO_PKT

# The living channel's window cadence (the reference's semantic constant),
# and the default execution chunk.
CHUNK_CYCLES = 128


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[g, n, idx[g, n]]`` for ``a`` of shape [G, N, K]."""
    return torch.gather(a, 2, idx.long()[..., None])[..., 0]


def drain_done(ss, st, t0: int, mem_on: bool = False) -> torch.Tensor:
    """Per lane [G]: True iff no future cycle can change the state (except
    the awake/sleep accounting).  ``mem_on`` is the flag the step was
    built with: without it ``rdy``/``dead`` are placeholders and are not
    read."""
    G = st.pkt_src.shape[0]
    no_pkts = ~(st.pkt_src >= 0).reshape(G, -1).any(-1)
    pipes_empty = ~(st.pipe != 0).reshape(G, -1).any(-1)
    no_inj = ~(st.inj_vc >= 0).any(-1)
    K = ss.births.shape[2]
    qh = st.q_head.clamp(0, K - 1)
    open_slot = st.q_head < K
    idle_head = _take_rows(ss.births, qh) >= int(NO_PKT)
    if mem_on:
        # a reply slot births when the bank model writes its ``rdy``; a
        # tombstoned head would still advance q_head (the dead-slot skip)
        idle_head &= _take_rows(st.rdy, qh) >= int(NO_PKT)
        idle_head &= ~_take_rows(st.dead, qh)
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


def replay_windows(window_fn: Callable, st, stop: Sequence[int],
                   budgets: Sequence[int]):
    """Apply ``window_fn(st, b)`` at every window boundary ``b`` (a
    multiple of ``CHUNK_CYCLES``) in ``[ceil(stop / W) * W, budget)`` of
    each lane, masking the lanes whose range does not hold ``b``.

    The step applies the living-channel update at every boundary it runs
    through; a lane that stopped at ``stop`` (a drain, aligned to the
    execution chunk and not necessarily to the window) never ran the
    later ones, while a monolithic run of its budget does.
    The update writes only the dynamic link tables and ``wl_resel``, so
    replaying it leaves the drained lane bitwise equal to that run.
    """
    W = CHUNK_CYCLES
    first = [-(-int(s) // W) * W for s in stop]
    dev = st.wl_resel.device
    for b in range(min(first), max(budgets), W):
        on = [f <= b < c for f, c in zip(first, budgets)]
        if any(on):
            st = _select(torch.tensor(on, device=dev), window_fn(st, b), st)
    return st


def run_chunked(step: Callable, ss, st, budgets: Sequence[int],
                mem_on: bool = False, window_fn: Callable | None = None,
                chunk: int = CHUNK_CYCLES):
    """Drive ``step(st, t) -> st`` over lane-leading ``st`` to each lane's
    budget, with early drain exit every ``chunk`` cycles.

    ``budgets`` are the lanes' cycle budgets on the host (equal to
    ``ss.cycles``): where every lane is stepping and the cycle lies within
    every budget, no per-cycle mask is needed, and no cycle at or past
    the largest budget is stepped.  ``mem_on`` as in ``drain_done``.
    ``window_fn(st, t) -> st`` is the living channel's boundary update,
    which the step applies at every multiple of ``CHUNK_CYCLES`` (the
    window cadence, not ``chunk``); with it the boundaries a drained lane
    skipped are replayed (``replay_windows``).
    """
    if not isinstance(chunk, numbers.Integral) or chunk < 1:
        raise ValueError(f"chunk must be a positive integer; got {chunk!r}")
    chunk = int(chunk)
    G, lo, hi = len(budgets), min(budgets), max(budgets)
    cycles = ss.cycles
    dev = cycles.device
    stopped = torch.zeros(G, dtype=torch.bool, device=dev)
    stop = torch.zeros(G, dtype=torch.int32, device=dev)
    t0 = 0
    while True:
        cont = ~stopped & (t0 < cycles) & ~drain_done(ss, st, t0, mem_on)
        newly = ~stopped & ~cont
        stop = torch.where(newly, t0, stop)
        stopped = stopped | newly
        cont_h = cont.cpu()            # the one host sync per chunk
        if not bool(cont_h.any()):
            break
        all_on = bool(cont_h.all())
        # a cycle at or past every budget is masked off in every lane
        for t in range(t0, min(t0 + chunk, hi)):
            new = step(st, t)
            unmasked = all_on and t < lo
            st = new if unmasked else _select(cont & (t < cycles), new, st)
        t0 += chunk
    if window_fn is not None:
        st = replay_windows(window_fn, st, stop.tolist(), budgets)
    return _finalize(ss, st, stop)
