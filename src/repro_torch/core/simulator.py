"""Cycle-accurate flit-level simulator for multichip NoCs (paper §IV), in
PyTorch.  Port of ``repro.core.simulator`` (the JAX reference).

Implements wormhole switching with virtual channels (8 VCs x 16-flit input
buffers), credit-equivalent backpressure, forwarding-table routing, the
paper's control-packet wireless MAC with partial packet transmission
(§III.D) and sleepy receivers [17], as one vectorized cycle step.

Data model (as in the reference)
--------------------------------
Everything is link-centric.  A *buffer* is the input buffer at the
downstream end of a directed link:

    [0, Lw)               wired links  (buffer id == routing link id)
    [Lw, Lw+Ninj)         injection links (core -> its switch)
    [Lw+Ninj, ...+n_wi)   wireless rx buffers (one per WI; all senders share)

Per (buffer, vc) state carries the current packet, its routing decision,
its claimed output VC and received/sent flit counters; flits in flight
live in a short arrival pipe (shift register).

What this port covers
---------------------
The whole reference step: all three wireless media (crossbar, matching,
single), both MAC modes (control packet, token), sleepy receivers, and

- *trace tables*: phase barriers (a packet injects once its phase is
  open; a phase closes at ``phase_need`` ejections) and multicast groups
  (``dests = -(1 + m)``: all-or-nothing VC claims at every member rx
  buffer, one shared-channel occupancy per flit fanned out through
  ``src_of``, transmit energy counted once on the primary copy);
  store-and-forward receivers under ``rx_hold``;
- *memory tables* under the static ``mem_on``: per-slot packet lengths,
  a request's ejection way forced to its pseudo-channel, the bank model
  (service from ``max(t + 1, bank_busy)``, row hit or miss), reply births
  in ``rdy`` by a one-assignment minimum, the ``max_outstanding`` gate on
  ``outst`` credited back at the requester, the ``amat_*``/``mem_*``
  counters;
- *the lossy PHY* under the static ``phy_on`` (a ``phy_spec`` on a fabric
  with wireless interfaces): per-(src WI, dst WI) rates and PER
  thresholds, packet-deep ARQ senders paced per pair (``pair_busy``), the
  CRC outcome of every attempt from the counter-based hash of
  ``phy.retx``, NACK and rewind, drops after ``max_retx`` attempts (the
  sender slot and the receiver VC freed, the phase barrier credited, and
  under ``mem_on`` the requester's window credited and a dropped
  request's reply slot tombstoned in ``dead``), broadcast ARQ for
  multicast groups anchored on the worst member link, and the per-pair
  air and energy counters;
- *the living channel* under the static ``drift_on``/``reselect`` (they
  imply ``phy_on``): the per-pair tables live in the carry and are
  refreshed at every ``CHUNK_CYCLES`` window boundary by
  ``phy.living.make_window_fn`` (the SNR drift walk and/or in-scan rate
  re-selection); the chunked driver replays the boundaries a lane skips
  after an early drain.

The multicast terms sit under a further static flag of the port's own,
``mc_on``: without multicast groups every one of them is inert, and
``pack`` leaves them out, so an open-loop point runs the open-loop
program alone.

Lanes
-----
Every ``SimStatic``/``SimState`` leaf handed to the step carries a
leading lane dimension G: a batch of sweep points runs in lockstep, one
operation per step for all lanes (the reference maps lanes one after
another with ``lax.map``).  Leaf names, per-lane shapes and dtypes are
the reference's, including the i8/i16 slimming and the placeholder shapes
of disabled paths, so states compare leaf by leaf.

Execution strategy
------------------
The step keeps the reference's formulation: static-index gathers, masked
min-reductions over static candidate tables with unique priority codes
``score * (B*V+1) + slot``, and elementwise updates — no scatters.
``jnp`` indexing clamps an out-of-range gather index (after wrapping a
negative one) where torch would fail; the reference clips almost every
gather explicitly, and the rest go through ``_jidx``, which applies the
same rule.  Gather indices are int64 at the point of use; stored dtypes
stay the reference's.  Nothing in the step reads a tensor value on the
host, so the step never synchronises with the device.

Drivers
-------
``run``, ``run_batch``, ``run_from`` and ``run_lanes`` take ``driver`` and
``chunk``.  The default ``driver="chunked"`` (``core/chunked.py``) steps
``chunk`` cycles between drain checks, one host sync per chunk, and stops
a drained lane early.  ``chunk`` is the execution chunk only: any
positive value gives the same state in every leaf but ``drain_cycle``.
``CHUNK_CYCLES`` stays the living channel's window cadence, the step's
``t % CHUNK_CYCLES == 0``, whatever the chunk.  ``driver="monolithic"``
steps one shared budget with no drain check: the oracle the chunked
driver is held against.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import chunked
from repro_torch.core.chunked import CHUNK_CYCLES
from repro_torch.core.constants import (WMAX, LinkClass, MacMode, PhyParams,
                                        SimParams)
from repro_torch.core.routing import RoutingTables
from repro_torch.core.topology import Topology
from repro_torch.core.traffic import NO_PKT, TrafficTable
from repro_torch.memory.model import MEM_CH, DEFAULT_DRAM
from repro_torch.phy.living import make_window_fn
from repro_torch.phy.retx import crc_fail

V = 8            # virtual channels per port (paper §IV)
DEPTH = 16       # buffer depth in flits (paper §IV)
DMAX = 12        # arrival-pipe depth >= max link latency
RXWMAX = 4       # max concurrent rx streams per WI (4-channel stacks, §IV)
EJ_WAYS = 4      # parallel ejection channels at memory-stack switches
assert MEM_CH == EJ_WAYS, "pseudo-channels must map 1:1 onto ejection ways"

i8, i16, i32, f32 = torch.int8, torch.int16, torch.int32, torch.float32


def _bucket(n: int, q: int) -> int:
    return int(np.ceil(max(n, 1) / q) * q)


class SimStatic(NamedTuple):
    """Padded, device-resident topology/routing/traffic description.

    Field meanings, shapes and dtypes are those of
    ``repro.core.simulator.SimStatic``; the step sees them with a leading
    lane dimension.
    """

    # buffers
    b_dst: torch.Tensor        # [B] dst switch (dummy rows -> S_pad-1)
    b_serv: torch.Tensor       # [B] cycles between flits INTO this buffer
    b_lat: torch.Tensor        # [B] forward -> arrival latency (>=1)
    b_epb: torch.Tensor        # [B] pJ/bit of the link feeding this buffer
    b_depth: torch.Tensor      # [B] buffer depth in flits
    b_wi: torch.Tensor         # [B] WI id at the buffer's switch (-1 none)
    b_is_rx: torch.Tensor      # [B] bool: wireless rx buffer
    b_ej_ways: torch.Tensor    # [B] parallel ejection channels at dst switch
    b_src_sw: torch.Tensor     # [B] switch transmitting into this buffer
    inj_src: torch.Tensor      # [B] source id whose injection buffer this is
    # routing
    next_out: torch.Tensor     # [S, S] routing output id
    o_buf: torch.Tensor        # [R] target buffer id (dummy B for eject/pad)
    o_wo: torch.Tensor         # [R] arbitration key
    o_is_wl: torch.Tensor      # [R] bool wireless pair link
    o_is_ej: torch.Tensor      # [R] bool ejection
    # arbitration candidate tables (static per topology)
    cands: torch.Tensor        # [S, CS] buffer ids feeding each switch (pad B)
    candr: torch.Tensor        # [W, CR] buffer ids able to tx to rx WI (pad B)
    wi_sw: torch.Tensor        # [W] switch of each WI (dummy S_pad-1)
    rxw: torch.Tensor          # scalar int32: rx sub-channels per WI (>=1)
    # wireless
    n_wi: torch.Tensor         # scalar int32
    rx0: torch.Tensor          # scalar int32: first rx buffer id
    # injection + traffic
    inj_buf: torch.Tensor      # [N] injection buffer id per source
    src_switch: torch.Tensor   # [N] switch of each source
    births: torch.Tensor       # [N, K]
    dests: torch.Tensor        # [N, K]
    # scalars
    pkt_len: torch.Tensor      # int32
    warmup: torch.Tensor       # int32
    cycles: torch.Tensor       # int32 per-lane cycle budget
    serv_wl: torch.Tensor      # int32 rx service cycles per flit
    lat_wl: torch.Tensor       # int32
    ctrl_cycles: torch.Tensor  # int32 control-packet duration
    mac_token: torch.Tensor    # bool: whole-packet token MAC [7]
    wl_sender_cap: torch.Tensor  # bool: one flit/cycle per transmitting WI
    wl_single: torch.Tensor    # bool: strict single shared channel
    wl_rx_busy: torch.Tensor   # bool: serialize each receiver (non-crossbar)
    sleepy: torch.Tensor       # bool
    # trace tables (inert for open-loop tables)
    phases: torch.Tensor       # [N, K] phase id per packet slot
    phase_need: torch.Tensor   # [P] ejections closing each phase
    n_phases: torch.Tensor     # scalar int32 (0 = open-loop, no gating)
    mc_member: torch.Tensor    # [M, WMAX] bool: receiver-WI set per group
    mc_dst: torch.Tensor       # [M, WMAX] final dst switch of the copy
    mc_route: torch.Tensor     # [M] pre-air routing anchor switch
    mc_prim: torch.Tensor      # [M] lowest member WI
    # memory tables (inert for open-loop tables)
    lens: torch.Tensor         # [N, K] per-slot packet length in flits
    mem_op: torch.Tensor       # [N, K] MEM_* op code (0 = none)
    mem_ch: torch.Tensor       # [N, K]
    mem_bank: torch.Tensor     # [N, K]
    mem_row: torch.Tensor      # [N, K]
    reply_row: torch.Tensor    # [N, K]
    reply_slot: torch.Tensor   # [N, K]
    req_src: torch.Tensor      # [N, K]
    req_birth: torch.Tensor    # [N, K]
    stack_sw: torch.Tensor     # [Y] stack base-logic-die switch (pad S-1)
    t_row_hit: torch.Tensor    # scalar i32
    t_row_miss: torch.Tensor   # scalar i32
    max_outst: torch.Tensor    # scalar i32
    # lossy PHY tables (inert unless ``phy_on``; ``rx_hold`` is also set
    # alone for multicast tables: store-and-forward receivers).  Broadcast
    # ARQ reads the same per-pair tables: group service and PER threshold
    # are the maximum over the member links
    wl_serv: torch.Tensor      # [WMAX, WMAX] flit cycles per (src, dst) WI
    wl_perq: torch.Tensor      # [WMAX, WMAX] 16-bit PER threshold per link
    rx_hold: torch.Tensor      # bool: rx slots hold whole packets
    max_retx: torch.Tensor     # scalar i32: ARQ attempt bound per packet
    phy_seed: torch.Tensor     # scalar int64 holding the u32 CRC hash seed
    ctrl_flits: torch.Tensor   # scalar i32: control-packet length in flits
    # living-channel tables (placeholder shapes unless drift_on/reselect;
    # the carry's dynamic tables then replace wl_serv/wl_perq)
    wl_rate0: torch.Tensor     # [WMAX, WMAX] i32 host-selected rate entry
    wl_snr: torch.Tensor       # [WMAX, WMAX] f32 undrifted SNR map (dB)
    wl_serv_r: torch.Tensor    # [R] i32 flit cycles per rate entry
    wl_perq_r: torch.Tensor    # [R, WMAX, WMAX] i32 PER threshold per entry
    wl_gp_q: torch.Tensor      # [R, WMAX, WMAX] i32 quantized goodput
    wl_gain_r: torch.Tensor    # [R] f32 processing gain per entry
    wl_gbps_r: torch.Tensor    # [R] f32 line rate per entry
    wl_pkt_bits: torch.Tensor  # f32 packet bits (PER recompute under drift)
    wl_drift_amp: torch.Tensor  # f32 aging amplitude in dB (0 = static)
    wl_drift_period: torch.Tensor  # i32 windows between drift knots


class SimState(NamedTuple):
    """Per-cycle state; leaves as in ``repro.core.simulator.SimState``."""

    # per (buffer, vc)
    pkt_src: torch.Tensor      # [B, V] int32, -1 = free
    pkt_idx: torch.Tensor      # [B, V]
    pkt_dst: torch.Tensor      # [B, V]
    born: torch.Tensor         # [B, V]
    out_o: torch.Tensor        # [B, V] routing output id
    out_buf: torch.Tensor      # [B, V]
    out_wo: torch.Tensor       # [B, V]
    out_is_wl: torch.Tensor    # [B, V] bool
    out_is_ej: torch.Tensor    # [B, V] bool
    out_vc: torch.Tensor       # [B, V] int8, -1 = unallocated
    phase2: torch.Tensor       # [B, V] bool: packet already crossed wireless
    rcvd: torch.Tensor         # [B, V]
    sent: torch.Tensor         # [B, V]
    src_of: torch.Tensor       # [B, V] flat upstream slot feeding this vc
    mc_id: torch.Tensor        # [B, V] multicast group id (-1 = unicast)
    attempt: torch.Tensor      # [B, V] int16 ARQ attempt
    pipe: torch.Tensor         # [B, V, DMAX] int8
    busy_until: torch.Tensor   # [B]
    wl_busy_until: torch.Tensor  # scalar: shared-channel mode
    pair_busy: torch.Tensor    # [WMAX, WMAX] per-(src, dst) WI busy-until
    # injection
    q_head: torch.Tensor       # [N]
    inj_vc: torch.Tensor       # [N] int8
    inj_pushed: torch.Tensor   # [N] int16
    # phase barrier
    cur_phase: torch.Tensor    # scalar
    phase_del: torch.Tensor    # scalar
    phase_end: torch.Tensor    # [P]
    phase_flits: torch.Tensor  # [P]
    # closed-loop memory (placeholder shapes unless mem_on)
    rdy: torch.Tensor          # [N, K] reply birth cycle (NO_PKT = ungated)
    dead: torch.Tensor         # [N, K] bool: tombstoned reply slot (its
    #                            request was ARQ-dropped; injection skips it)
    outst: torch.Tensor        # [N]
    bank_busy: torch.Tensor
    bank_row: torch.Tensor
    outst_peak: torch.Tensor   # [N]
    amat_sum: torch.Tensor
    amat_pkts: torch.Tensor
    mem_reads: torch.Tensor    # [Y]
    mem_writes: torch.Tensor
    mem_row_hits: torch.Tensor
    mem_q_sum: torch.Tensor
    mem_svc_sum: torch.Tensor
    mem_flits: torch.Tensor
    # stats (post-warmup)
    flits_inj: torch.Tensor
    flits_del: torch.Tensor
    pkts_del: torch.Tensor
    lat_sum: torch.Tensor      # float32
    lat_pkts: torch.Tensor
    counts_into: torch.Tensor  # [B] link-traversal events
    count_switch: torch.Tensor
    ctrl_count: torch.Tensor
    wl_tx_flits: torch.Tensor
    wl_rx_flits: torch.Tensor
    awake_cycles: torch.Tensor
    sleep_cycles: torch.Tensor
    # lossy-PHY stats (zero unless phy_on)
    wl_pair_flits: torch.Tensor  # [WMAX, WMAX] flit attempts per link
    wl_fail_flits: torch.Tensor  # [WMAX, WMAX] flits of CRC-failing attempts
    wl_pkts: torch.Tensor      # packets that crossed the air (CRC pass)
    wl_nacks: torch.Tensor     # failed attempts (NACK events)
    pkts_dropped: torch.Tensor  # packets dropped at max_retx
    wl_drop_flits: torch.Tensor  # payload flits lost to drops (x members)
    mem_drop_reads: torch.Tensor  # read round trips lost to drops
    # living-channel dynamics (placeholder shapes unless living): the
    # current per-pair link tables, refreshed per scan window
    wl_serv_d: torch.Tensor    # [WMAX, WMAX] i32 current flit cycles
    wl_perq_d: torch.Tensor    # [WMAX, WMAX] i32 current PER threshold
    wl_rate_d: torch.Tensor    # [WMAX, WMAX] i32 current rate entry
    wl_resel: torch.Tensor     # scalar: in-scan rate re-selections
    wl_rate_flits: torch.Tensor  # [R] flit attempts per rate entry
    wl_rate_fail: torch.Tensor   # [R] failing-attempt flits per rate entry
    # driver metadata
    cycles_run: torch.Tensor   # scalar i32
    drain_cycle: torch.Tensor  # scalar i32


def init_state(B: int, N: int, P: int = 1, K: int = 1, Y: int = 1,
               BK: int = 1, mem_on: bool = False, phy_on: bool = False,
               living: bool = False, R: int = 1, *,
               lanes: int | None = None, device=None) -> SimState:
    """Zero state, leaf for leaf the reference's ``init_state``.

    The closed-loop memory leaves (``rdy``, ``dead``, ``bank_busy``,
    ``bank_row``) take their real shapes only with ``mem_on``, the
    per-pair PHY leaves (``pair_busy``, ``wl_pair_flits``,
    ``wl_fail_flits``) only with ``phy_on``, and the living-channel
    tables ([WMAX, WMAX]) and per-entry counters ([R]) only with
    ``living``; otherwise they keep the reference's placeholder shapes.
    The living tables start zeroed: the window update fires at ``t == 0``
    before any read.  ``lanes`` prepends a lane dimension of that size to
    every leaf.
    """
    dev = _device.resolve(device)
    pre = () if lanes is None else (lanes,)

    def full(shape, val, dtype):
        return torch.full(pre + tuple(shape), val, dtype=dtype, device=dev)

    def z(shape, dtype=i32):
        return full(shape, 0, dtype)

    NK = (N, K) if mem_on else (1, 1)
    YCB = (Y, MEM_CH, BK) if mem_on else (1, 1, 1)
    WW = (WMAX, WMAX) if phy_on else (1, 1)
    WWL = (WMAX, WMAX) if living else (1, 1)
    RL = (R,) if living else (1,)
    BV = (B, V)
    return SimState(
        pkt_src=full(BV, -1, i32), pkt_idx=z(BV), pkt_dst=z(BV),
        born=z(BV), out_o=z(BV), out_buf=z(BV), out_wo=z(BV),
        out_is_wl=z(BV, torch.bool), out_is_ej=z(BV, torch.bool),
        out_vc=full(BV, -1, i8),
        phase2=z(BV, torch.bool), rcvd=z(BV), sent=z(BV),
        src_of=full(BV, -1, i32), mc_id=full(BV, -1, i32),
        attempt=z(BV, i16),
        pipe=z((B, V, DMAX), i8), busy_until=z((B,)),
        wl_busy_until=z(()),
        pair_busy=z(WW),
        q_head=z((N,)), inj_vc=full((N,), -1, i8),
        inj_pushed=z((N,), i16),
        cur_phase=z(()), phase_del=z(()),
        phase_end=z((P,)), phase_flits=z((P,)),
        rdy=full(NK, int(NO_PKT), i32),
        dead=z(NK, torch.bool), outst=z((N,)),
        bank_busy=z(YCB), bank_row=full(YCB, -1, i32),
        outst_peak=z((N,)),
        amat_sum=z((), f32), amat_pkts=z(()),
        mem_reads=z((Y,)), mem_writes=z((Y,)), mem_row_hits=z((Y,)),
        mem_q_sum=z((Y,), f32), mem_svc_sum=z((Y,), f32),
        mem_flits=z((Y,)),
        flits_inj=z(()), flits_del=z(()), pkts_del=z(()),
        lat_sum=z((), f32), lat_pkts=z(()),
        counts_into=z((B,)), count_switch=z(()), ctrl_count=z(()),
        wl_tx_flits=z(()), wl_rx_flits=z(()),
        awake_cycles=z(()), sleep_cycles=z(()),
        wl_pair_flits=z(WW), wl_fail_flits=z(WW),
        wl_pkts=z(()), wl_nacks=z(()), pkts_dropped=z(()),
        wl_drop_flits=z(()), mem_drop_reads=z(()),
        wl_serv_d=z(WWL), wl_perq_d=z(WWL), wl_rate_d=z(WWL),
        wl_resel=z(()),
        wl_rate_flits=z(RL), wl_rate_fail=z(RL),
        cycles_run=z(()), drain_cycle=z(()),
    )


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------

def _jidx(i: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp`` gather index rule: wrap a negative index once, then clamp."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per-lane gather ``a[g, i[g, ...]]`` along ``a``'s axis 1.

    ``a`` is lane-leading ([G, D, *rest]); ``i`` is lane-leading too and
    in range.  The result has shape ``i.shape + rest``.
    """
    G = a.shape[0]
    rest = a.shape[2:]
    il = i.long().reshape((G, -1) + (1,) * len(rest))
    if rest:
        il = il.expand((G, -1) + tuple(rest))
    return torch.gather(a, 1, il).reshape(tuple(i.shape) + tuple(rest))


def take2(a: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Per-lane gather ``a[g, i, j]`` for ``a`` of shape [G, D1, D2]."""
    return take(a.reshape(a.shape[0], -1), i * a.shape[2] + j)


class Derived(NamedTuple):
    """Per-run constants of the step, computed once from ``SimStatic``.

    The reference recomputes these inside the step (XLA hoists them); in
    eager PyTorch they are hoisted by hand.
    """

    idx_w: torch.Tensor      # [G, B, CS, V] contenders per wired target
    cw_ok: torch.Tensor      # [G, B, CS, 1]
    idx_r: torch.Tensor      # [G, W, CR, V] contenders per rx target
    cr_ok: torch.Tensor      # [G, W, CR, 1]
    rx_tgt: torch.Tensor     # [G, W, 1, 1] rx buffer id of receiver w
    idx_s: torch.Tensor      # [G, S, CS, V] slots at each switch
    cs_ok: torch.Tensor      # [G, S, CS, 1] real candidate
    way_ok: torch.Tensor     # [G, EJ, S, CS, V] candidate on ejection way e
    sub_ok: torch.Tensor     # [G, RXW, W, CR, 1] sender on rx sub-channel r
    idx_t: torch.Tensor      # [G, W, CS, V] slots at each WI's switch
    cT_ok: torch.Tensor      # [G, W, CS, 1]
    way_bv: torch.Tensor     # [G, B, V] ejection way of each slot
    r_mine: torch.Tensor     # [G, B, V] rx sub-channel of each slot
    wi_c: torch.Tensor       # [G, B] b_wi clipped to [0, WMAX)
    rx_ids: torch.Tensor     # [G, W] rx buffer ids, clipped
    rx_slot: torch.Tensor    # [G, B] buffer -> receiver index, clipped
    rx_live: torch.Tensor    # [G, W] receiver exists
    hold_bv: torch.Tensor    # [G, B, 1] store-and-forward rx buffer
    flat2d: torch.Tensor     # [B, V] flat slot id, int32
    warr: torch.Tensor       # [WMAX] receiver ids
    ej_ar: torch.Tensor      # [EJ, 1, 1, 1] ejection way ids
    vcol: torch.Tensor       # [V] int32
    b_ids: torch.Tensor      # [B] int32
    n_ar: torch.Tensor       # [N]
    parr: torch.Tensor       # [P] int32
    d_ar: torch.Tensor       # [DMAX]
    pipe_pad: torch.Tensor   # [G, B, V, 1] int8 zeros (pipe shift-in)


def derive(ss: SimStatic, B: int) -> Derived:
    G, S = ss.next_out.shape[0], ss.next_out.shape[1]
    N, P = ss.births.shape[1], ss.phase_need.shape[1]
    dev = ss.b_dst.device
    varr = torch.arange(V, device=dev)
    warr = torch.arange(WMAX, device=dev)
    rx0 = ss.rx0[:, None]
    cw = take(ss.cands, ss.b_src_sw.clamp(0, S - 1))                # [G,B,CS]
    idx_w = cw.clamp(0, B - 1).long()[..., None] * V + varr
    crc = ss.candr.clamp(0, B - 1)                                  # [G,W,CR]
    idx_r = crc.long()[..., None] * V + varr
    idx_s = ss.cands.clamp(0, B - 1).long()[..., None] * V + varr
    cs_ok = (ss.cands < B)[..., None]
    way_bv = varr.to(i32) % ss.b_ej_ways[:, :, None]                # [G,B,V]
    way_s = take(way_bv.reshape(G, -1), idx_s)                      # [G,S,CS,V]
    ej_ar = torch.arange(EJ_WAYS, device=dev)[:, None, None, None]
    way_ok = cs_ok[:, None] & (way_s[:, None] == ej_ar)
    rxw = ss.rxw.clamp(min=1)
    r_cand = (take(ss.b_wi, crc) % rxw[:, None, None])[..., None]   # [G,W,CR,1]
    sub_ok = r_cand[:, None] == torch.arange(
        RXWMAX, device=dev)[:, None, None, None]
    wi_sw_c = ss.wi_sw.clamp(0, S - 1)
    r_mine = (ss.b_wi % rxw[:, None]).clamp(0, RXWMAX - 1)
    return Derived(
        idx_w=idx_w, cw_ok=(cw < B)[..., None],
        idx_r=idx_r, cr_ok=(ss.candr < B)[..., None],
        rx_tgt=(rx0 + warr)[..., None, None],
        idx_s=idx_s, cs_ok=cs_ok, way_ok=way_ok, sub_ok=sub_ok,
        idx_t=take(idx_s, wi_sw_c), cT_ok=take(cs_ok, wi_sw_c),
        way_bv=way_bv,
        r_mine=r_mine[:, :, None].expand(G, B, V),
        wi_c=ss.b_wi.clamp(0, WMAX - 1),
        rx_ids=(rx0 + warr).clamp(0, B - 1),
        rx_slot=(torch.arange(B, device=dev) - rx0).clamp(0, WMAX - 1),
        rx_live=warr < ss.n_wi[:, None],
        hold_bv=(ss.rx_hold[:, None] & ss.b_is_rx)[..., None],
        flat2d=torch.arange(B * V, dtype=i32, device=dev).reshape(B, V),
        warr=warr, ej_ar=ej_ar,
        vcol=varr.to(i32), b_ids=torch.arange(B, dtype=i32, device=dev),
        n_ar=torch.arange(N, device=dev),
        parr=torch.arange(P, dtype=i32, device=dev),
        d_ar=torch.arange(DMAX, device=dev),
        pipe_pad=torch.zeros((G, B, V, 1), dtype=i8, device=dev),
    )


def _route_fields(ss: SimStatic, at_switch, dst):
    """Gather the routing decision for packets at `at_switch` going to `dst`."""
    S, R = ss.next_out.shape[1], ss.o_buf.shape[1]
    oo = take2(ss.next_out, _jidx(at_switch, S), _jidx(dst, S))
    oc = _jidx(oo, R)
    return (oo, take(ss.o_buf, oc), take(ss.o_wo, oc), take(ss.o_is_wl, oc),
            take(ss.o_is_ej, oc))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``argmax`` of a bool mask over the last axis (0 when none), int32."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=i32, device=mask.device)
    first = torch.where(mask, ar, n).amin(-1)
    return torch.where(first < n, first, 0)


def _sum_i32(x: torch.Tensor, dims) -> torch.Tensor:
    return x.sum(dims, dtype=i32)


def make_step(B: int, mem_on: bool = False, phy_on: bool = False,
              drift_on: bool = False, reselect: bool = False,
              mc_on: bool = True):
    """Build the per-cycle transition ``step(ss, d, st, t) -> st``.

    ``ss``/``st`` are lane-leading; ``d = derive(ss, B)``; ``t`` is the
    cycle (a Python int, shared by all lanes).  ``mem_on`` (static, as in
    the reference) adds the closed-loop memory path: bank model, reply
    gating, the outstanding-transaction cap, per-slot packet lengths.
    ``phy_on`` (static) adds the lossy-channel ARQ path: per-link rates
    and pacing, CRC retransmission, drops.  ``drift_on``/``reselect``
    (static, imply ``phy_on``) add the living channel: the per-pair
    tables are read from the carry and refreshed at window boundaries by
    ``phy.living.make_window_fn``.  ``mc_on`` (static, the port's own)
    keeps the multicast terms; with it off they are left out, which is
    exact only for tables without multicast groups (there every one of
    them is inert): the drivers set it from the tables.
    """
    living = drift_on or reselect
    assert not living or phy_on, "living channel requires the ARQ path"
    NC = B * V
    NCp1 = NC + 1
    assert NC * (NC + 1) < 2**31, \
        f"B={B}: priority codes would overflow int32 (B*V must be < 46341)"
    BIGC = NC * NCp1
    BIGS = 1 << 30

    def step(ss: SimStatic, d: Derived, st: SimState, t: int) -> SimState:
        G = st.pkt_src.shape[0]
        S = ss.next_out.shape[1]
        P = ss.phase_need.shape[1]
        M = ss.mc_member.shape[1]
        N, K = ss.births.shape[1], ss.births.shape[2]
        flat2d, vcol, b_ids = d.flat2d, d.vcol, d.b_ids
        classA = vcol < V // 2
        warr = d.warr

        def lane(x, nd):            # [G] per-lane scalar -> broadcastable
            return x.view((G,) + (1,) * (nd - 1))

        def group_of(mc_id):        # multicast table rows of each slot
            return take(ss.mc_member, mc_id.clamp(0, M - 1))      # [G,B,V,W]

        def member_at(mcf, idx):    # candidates' groups hold receiver w
            gm = take(mcf, idx)                                   # [G,W,C,V]
            return (gm >= 0) & take2(ss.mc_member, gm.clamp(0, M - 1),
                                     warr[:, None, None])

        if living and t % CHUNK_CYCLES == 0:
            # living channel: refresh the per-pair link tables at every
            # scan-window boundary (the chunked driver replays the ones a
            # drained lane skips)
            st = make_window_fn(ss, drift_on, reselect)(st, t)
        post = (ss.warmup <= t).to(i32)                          # [G]
        rot = t % NC
        prio = ((flat2d - rot) % NC) * NCp1 + flat2d             # [B, V]

        # ---- 1. arrivals -------------------------------------------------
        arrive = st.pipe[..., 0]
        rcvd = st.rcvd + arrive
        pipe = torch.cat([st.pipe[..., 1:], d.pipe_pad], dim=-1)
        active = st.pkt_src >= 0
        occ = torch.where(active, rcvd - st.sent, 0)

        # ---- 2a. output-VC claims ---------------------------------------
        # one new downstream-VC allocation per target buffer per cycle;
        # VC classes break wormhole cycles (pre-wireless [0, V/2), post
        # [V/2, V); rx buffers admit any VC)
        free_mask = st.pkt_src < 0                                # [G,B,V]
        ob_c0 = st.out_buf.clamp(0, B - 1).long()
        tgt_rx = take(ss.b_is_rx, ob_c0)                          # [G,B,V]
        allowed = torch.where(
            tgt_rx[..., None], True,
            torch.where(st.phase2[..., None], ~classA, classA))   # [G,B,V,V]
        free_ok = take(free_mask, ob_c0) & allowed
        has_free_c = free_ok.any(-1)
        first_free_c = _first_true(free_ok)                       # [G,B,V]
        # store-and-forward receivers (rx_hold): an rx slot claims its
        # downstream VC only once the whole packet has arrived
        if mem_on:
            plen0 = take2(ss.lens, st.pkt_src.clamp(0, N - 1),
                          st.pkt_idx.clamp(0, K - 1))
        else:
            plen0 = lane(ss.pkt_len, 3)
        hold0_ok = ~d.hold_bv | (rcvd >= plen0)
        need_base = active & (st.out_vc < 0) & ~st.out_is_ej & (occ > 0) \
            & (st.out_buf < B) & hold0_ok
        if mc_on:
            # multicast senders (group set, air hop ahead) need a VC at
            # EVERY member rx buffer: the claim is all-or-nothing.  A copy
            # (phase2 set at rx install) is a plain unicast again.
            is_mc0 = (st.mc_id >= 0) & st.out_is_wl & ~st.phase2 & active
            member0 = group_of(st.mc_id)                          # [G,B,V,W]
            free_any_rx = take(free_mask, d.rx_ids).any(-1)       # [G,W]
            free_all_mc = torch.where(member0, free_any_rx[:, None, None],
                                      True).all(-1)
            need_uni = need_base & ~is_mc0 & has_free_c
            need_mc = need_base & is_mc0 & free_all_mc
            need = need_uni | need_mc
        else:
            need = need_uni = need_base & has_free_c
        code = torch.where(need, prio, BIGC)                      # [G,B,V]
        codef = code.reshape(G, -1)
        obf0 = st.out_buf.reshape(G, -1)

        # winner (min code) per wired target buffer: contenders live at the
        # buffers feeding the target's transmitting switch
        m_w = d.cw_ok & (take(obf0, d.idx_w) == b_ids[:, None, None])
        win_code_w = torch.where(m_w, take(codef, d.idx_w),
                                 BIGC).amin((2, 3))               # [G,B]
        # winner per wireless rx target: contenders at sender WI switches;
        # a multicast contends at every member receiver at once
        m_r = take(obf0, d.idx_r) == d.rx_tgt
        if mc_on:
            mcf0 = torch.where(is_mc0, st.mc_id, -1).reshape(G, -1)
            m_r = m_r | member_at(mcf0, d.idx_r)
        win_code_r = torch.where(d.cr_ok & m_r, take(codef, d.idx_r),
                                 BIGC).amin((2, 3))               # [G,W]
        win_code = torch.where(ss.b_is_rx, take(win_code_r, d.rx_slot),
                               win_code_w)
        has_win = win_code < BIGC                                 # [G,B]
        wsrc = torch.where(has_win, win_code % NCp1, 0)           # flat slot
        wsrc_l = wsrc.long()
        win_uni = need_uni & (take(win_code, ob_c0) == code)

        def g(a):            # winner's field per target buffer -> [G,B]
            return take(a.reshape(G, -1), wsrc_l)

        vfree_self = _first_true(free_mask)                       # [G,B]
        vstar = torch.where(ss.b_is_rx, vfree_self, g(first_free_c))
        dst_w = g(st.pkt_dst)
        if mc_on:
            # source side: a multicast claim stands only if it won EVERY
            # member; target side: a partial multicast winner claims
            # nothing, and each member copy goes to its own per-WI
            # destination from the group table
            win_all_mc = torch.where(
                member0, win_code_r[:, None, None] == code[..., None],
                True).all(-1)                                     # [G,B,V]
            win_mc = need_mc & win_all_mc
            w_mc = take(mcf0, wsrc_l)                             # [G,B]
            w_group_ok = g(win_all_mc)
            has_win = has_win & ((w_mc < 0) | w_group_ok)
            mc_dst_w = take2(ss.mc_dst, w_mc.clamp(0, M - 1), d.rx_slot)
            dst_w = torch.where(ss.b_is_rx & (w_mc >= 0),
                                mc_dst_w.clamp(0, S - 1), dst_w)
        claimed = has_win[..., None] & (vstar[..., None] == vcol)  # [G,B,V]
        d_oo, d_ob, d_owo, d_owl, d_oej = _route_fields(ss, ss.b_dst, dst_w)

        def upd(old, val_b):
            return torch.where(claimed, val_b[..., None], old)

        pkt_src = upd(st.pkt_src, g(st.pkt_src))
        pkt_idx = upd(st.pkt_idx, g(st.pkt_idx))
        pkt_dst = upd(st.pkt_dst, dst_w)
        born = upd(st.born, g(st.born))
        out_o = upd(st.out_o, d_oo.to(i32))
        out_buf = upd(st.out_buf, d_ob.to(i32))
        out_wo = upd(st.out_wo, d_owo.to(i32))
        out_is_wl = upd(st.out_is_wl, d_owl)
        out_is_ej = upd(st.out_is_ej, d_oej)
        out_vc = torch.where(claimed, -1, st.out_vc)
        phase2 = upd(st.phase2, g(st.phase2) | ss.b_is_rx)
        mc_id = upd(st.mc_id, g(st.mc_id)) if mc_on else st.mc_id
        attempt = torch.where(claimed, 0, st.attempt)
        rcvd = torch.where(claimed, 0, rcvd)
        sent = torch.where(claimed, 0, st.sent)
        src_of = upd(st.src_of, wsrc)
        # upstream learns its allocated VC (multicast: the sentinel 0 for
        # "granted"; delivery is receiver-side via src_of)
        out_vc = torch.where(win_uni, first_free_c.to(out_vc.dtype), out_vc)
        if mc_on:
            out_vc = torch.where(win_mc, 0, out_vc)

        active = pkt_src >= 0
        occ = torch.where(active, rcvd - sent, 0)
        psrc_c = pkt_src.clamp(0, N - 1)
        pidx_c = pkt_idx.clamp(0, K - 1)
        # per-slot packet attributes from the [N, K] tables; without
        # mem_on the global packet length stands in and ejection ways stay
        # vc-assigned (the open-loop program)
        if mem_on:
            plen = take2(ss.lens, psrc_c, pidx_c)                 # [G,B,V]
            op_bv = torch.where(active, take2(ss.mem_op, psrc_c, pidx_c), 0)
            memrq_bv = (op_bv == 1) | (op_bv == 2)
            ch_bv = take2(ss.mem_ch, psrc_c, pidx_c).clamp(0, EJ_WAYS - 1)
            # a request's ejection way IS its pseudo-channel: per-way
            # arbitration then admits one request per (stack, ch)/cycle
            way_bv = torch.where(memrq_bv & out_is_ej,
                                 ch_bv % ss.b_ej_ways[..., None], d.way_bv)
            way_s = take(way_bv.reshape(G, -1), d.idx_s)          # [G,S,CS,V]
            way_ok = d.cs_ok[:, None] & (way_s[:, None] == d.ej_ar)
        else:
            plen = lane(ss.pkt_len, 3)
            way_bv, way_ok = d.way_bv, d.way_ok

        # ---- 2b. forwarding: wired links, ejection, wireless -------------
        inflight = pipe.sum(-1, dtype=i32)                        # [G,B,V]
        ob_c = out_buf.clamp(0, B - 1).long()
        ovc_c = out_vc.clamp(0, V - 1)
        down = ob_c * V + ovc_c                                   # flat slot
        occ_down = take(rcvd.reshape(G, -1), down) \
            - take(sent.reshape(G, -1), down)
        space = take(ss.b_depth, ob_c) - occ_down \
            - take(inflight.reshape(G, -1), down)
        link_free = take(st.busy_until, ob_c) <= t
        if mc_on:
            # multicast sender: backpressure is the MINIMUM over its member
            # copies (found through the src_of inverse map on the rx
            # region); a broadcast flit flies only when every member can
            # take it
            is_mc = (mc_id >= 0) & out_is_wl & ~phase2 & active   # [G,B,V]
            mcid_c = mc_id.clamp(0, M - 1)
            member = group_of(mc_id)                              # [G,B,V,W]
            srcof_rx = take(src_of, d.rx_ids)                     # [G,W,V]
            room_rx = take(ss.b_depth, d.rx_ids)[..., None] \
                - take(occ, d.rx_ids) - take(inflight, d.rx_ids)  # [G,W,V]
            cp = srcof_rx[:, None, None] == flat2d[:, :, None, None]
            cp_space = torch.where(cp, room_rx[:, None, None],
                                   BIGS).amin(-1)                 # [G,B,V,W]
            cp_space = torch.where(cp.any(-1), cp_space, 0)       # no copy yet
            space_mc = torch.where(member, cp_space, BIGS).amin(-1)
            space = torch.where(is_mc, space_mc, space)
            busy_rx_ok = take(st.busy_until, d.rx_ids) <= t       # [G,W]
            lf_mc = torch.where(member, busy_rx_ok[:, None, None],
                                True).all(-1)
            link_free = torch.where(is_mc, lf_mc, link_free)
        # token MAC: wireless transmission only once the whole packet is here
        whole = rcvd >= plen
        wl_ok = ~out_is_wl | ~lane(ss.mac_token, 3) | whole
        # single-channel mode: nothing flies while the channel is busy
        wl_ch_free = ~ss.wl_single | (st.wl_busy_until <= t)      # [G]
        wl_ok &= ~out_is_wl | lane(wl_ch_free, 3)
        # crossbar medium: receivers are not serialized
        link_free |= out_is_wl & ~lane(ss.wl_rx_busy, 3)
        # store-and-forward receivers: rx slots forward only whole packets
        hold_ok = ~d.hold_bv | whole
        if phy_on:
            # lossy PHY: the sender holds the whole packet (ARQ needs it
            # for retransmission), the (src, dst) WI pair paces at the
            # link's rate, and the attempt's CRC outcome is a hash known
            # sender-side; living points read the carry's tables
            serv_tab = st.wl_serv_d if living else ss.wl_serv    # [G,W,W]
            perq_tab = st.wl_perq_d if living else ss.wl_perq
            wd_bv = out_wo.clamp(0, WMAX - 1)                     # [G,B,V]
            pair = d.wi_c[..., None] * WMAX + wd_bv               # flat pair
            serv_wl_bv = take(serv_tab.reshape(G, -1), pair)
            perq_bv = take(perq_tab.reshape(G, -1), pair)
            if mc_on:
                # broadcast ARQ: a multicast attempt is paced and
                # CRC-checked against its worst member link (the hash draw
                # is link-independent, so "any member fails" is "the
                # worst member fails")
                serv_mc = _group_link(take(serv_tab, d.wi_c), member)
                perq_mc = _group_link(take(perq_tab, d.wi_c), member)
                serv_wl_bv = torch.where(is_mc, serv_mc, serv_wl_bv)
                perq_bv = torch.where(is_mc, perq_mc, perq_bv)
            pb_ok = take(st.pair_busy.reshape(G, -1), pair) <= t
            wl_ok &= ~out_is_wl | (whole & pb_ok)
            # the packet uid does not depend on padding (pkt_idx < 2^16)
            fail_bv = crc_fail(lane(ss.phy_seed, 3), psrc_c * 65536 + pidx_c,
                               attempt, perq_bv)
        elig = active & (occ > 0) & wl_ok & hold_ok \
            & (out_is_ej | ((out_vc >= 0) & (space > 0) & link_free))
        code2 = torch.where(elig, prio, BIGC)
        code2f = code2.reshape(G, -1)
        obf = out_buf.reshape(G, -1)

        # wired-output winners: one flit per link per cycle
        m2_w = d.cw_ok & (take(obf, d.idx_w) == b_ids[:, None, None])
        win2_w = torch.where(m2_w, take(code2f, d.idx_w), BIGC).amin((2, 3))
        # multi-channel ejection: one winner per (switch, way); a slot's
        # way is vc % b_ej_ways (memory requests: their channel)
        m_ej = take(out_is_ej.reshape(G, -1), d.idx_s)            # [G,S,CS,V]
        win2_ej = torch.where(way_ok & m_ej[:, None],
                              take(code2f, d.idx_s)[:, None],
                              BIGC).amin((3, 4))                  # [G,EJ,S]
        # wireless rx sub-channels: receiver w serves `rxw` concurrent
        # streams; a sender's stream is its WI id mod rxw.  A multicast
        # contends at every member receiver (on its own sub-channel) and
        # transmits only if it wins ALL of them
        m2_r = take(obf, d.idx_r) == d.rx_tgt                     # [G,W,CR,V]
        if mc_on:
            mcf = torch.where(is_mc, mc_id, -1).reshape(G, -1)
            m2_r = m2_r | member_at(mcf, d.idx_r)
        win2_wl = torch.where(d.sub_ok & (d.cr_ok & m2_r)[:, None],
                              take(code2f, d.idx_r)[:, None],
                              BIGC).amin((3, 4))                  # [G,RXW,W]

        owo_s = out_wo.clamp(0, S - 1)                            # eject: switch
        owo_w = out_wo.clamp(0, WMAX - 1)                         # wl: dst WI
        win2_mine = torch.where(
            out_is_ej, take2(win2_ej, way_bv, owo_s),
            torch.where(out_is_wl, take2(win2_wl, d.r_mine, owo_w),
                        take(win2_w, ob_c)))
        if mc_on:
            r_all = take2(win2_wl, d.r_mine[..., None],
                          warr.expand(G, B, V, WMAX))             # [G,B,V,W]
            wl_all2 = torch.where(member, r_all == code2[..., None],
                                  True).all(-1)
            fwd = elig & torch.where(is_mc, wl_all2, code2 == win2_mine)
        else:
            fwd = elig & (code2 == win2_mine)

        # wireless sender-side cap: one flit per transmitting WI per cycle
        # (one WI total in single-channel mode); no-op for the crossbar
        capped = fwd & out_is_wl & lane(ss.wl_sender_cap, 3)
        cap_code = torch.where(capped, code2, BIGC).reshape(G, -1)
        win3 = torch.where(d.cT_ok, take(cap_code, d.idx_t),
                           BIGC).amin((2, 3))                     # [G,W]
        my3 = torch.where(lane(ss.wl_single, 3),
                          lane(win3.amin(-1), 3),
                          take(win3, d.wi_c)[..., None])
        fwd &= ~capped | (code2 == my3)
        is_wl_fwd = fwd & out_is_wl

        sent = sent + fwd.to(i32)
        phy = {}
        if phy_on:
            # CRC check on the tail of every air attempt: a NACK rewinds
            # the sender (the whole packet is still buffered), the
            # bounded-ARQ loser is dropped (its sender slot and claimed
            # receiver VC are freed below; nothing was delivered)
            first_wl = is_wl_fwd & (sent == 1)       # pre-rewind header
            raw_tail = fwd & (sent >= plen)
            fail_tail = raw_tail & out_is_wl & fail_bv
            retx_m = fail_tail & (attempt + 1 < lane(ss.max_retx, 3))
            drop = fail_tail & ~retx_m
            tail = raw_tail & ~fail_tail
            sent = torch.where(retx_m, sent - plen, sent)
            attempt = torch.where(retx_m, attempt + 1, attempt)
            # a drop's ejections never happen: count the lost payload
            # (once per member copy for multicast, as wl_rx_flits)
            member_cnt = torch.where(is_mc, _sum_i32(member, -1), 1) \
                if mc_on else 1
            phy.update(
                wl_nacks=st.wl_nacks + post * _sum_i32(fail_tail, (1, 2)),
                wl_pkts=st.wl_pkts + post * _sum_i32(tail & out_is_wl,
                                                     (1, 2)),
                pkts_dropped=st.pkts_dropped + post * _sum_i32(drop, (1, 2)),
                wl_drop_flits=st.wl_drop_flits + post * _sum_i32(
                    torch.where(drop, plen * member_cnt, 0), (1, 2)))
        else:
            first_wl = is_wl_fwd & (sent == 1)   # header => control packet
            tail = fwd & (sent >= plen)
        ej = fwd & out_is_ej

        # ejection stats
        n_ej = _sum_i32(ej, (1, 2))
        flits_del = st.flits_del + post * n_ej
        tail_ej = tail & out_is_ej
        lat_ok = tail_ej & (born >= lane(ss.warmup, 3))
        pkts_del = st.pkts_del + post * _sum_i32(tail_ej, (1, 2))
        lat_sum = st.lat_sum + post * torch.where(
            lat_ok, (t - born + 1).to(f32), 0.0).sum((1, 2))
        lat_pkts = st.lat_pkts + post * _sum_i32(lat_ok, (1, 2))

        # ---- phase barrier bookkeeping (raw counts: the dependency
        # structure must not depend on the stats warm-up)
        phv = take2(ss.phases, psrc_c, pidx_c)                     # [G,B,V]
        cur = st.cur_phase
        phase_del = st.phase_del + _sum_i32(
            tail_ej & (phv == lane(cur, 3)), (1, 2))
        if phy_on:
            # an ARQ drop's ejections (one per member copy) never happen:
            # credit them to the open phase so a lossy trace drains
            phase_del = phase_del + _sum_i32(torch.where(
                drop & (phv == lane(cur, 3)), member_cnt, 0), (1, 2))
        at_cur = d.parr == cur[:, None]                             # [G,P]
        phase_flits = st.phase_flits + torch.where(at_cur, n_ej[:, None], 0)
        in_trace = (ss.n_phases > 0) & (cur < ss.n_phases)
        needed = take(ss.phase_need, cur.clamp(0, P - 1))
        complete = in_trace & (phase_del >= needed)
        phase_end = torch.where(at_cur & complete[:, None], t + 1,
                                st.phase_end)
        cur_phase = cur + complete.to(i32)
        phase_del = torch.where(complete, 0, phase_del)

        # ---- closed-loop memory: bank model + reply gating (mem tables)
        mem = {}
        if mem_on:
            mem = _memory_block(ss, st, t, post, pkt_src, pkt_idx, tail,
                                tail_ej, win2_ej, psrc_c, pidx_c,
                                NCp1, BIGC)

        # non-eject: deliver downstream via the src_of inverse map — each
        # target (buffer, vc) gathers from the unique upstream slot feeding
        # it (identity-checked against out_buf/out_vc to survive slot reuse)
        if phy_on:
            # per-link rate: serialization and control-packet time follow
            # the (src, dst) WI pair's rate
            ctrl = (lane(ss.ctrl_flits, 3) * serv_wl_bv).clamp(min=1)
            lat_wl = lane(ss.lat_wl - ss.serv_wl, 3) + serv_wl_bv
        else:
            ctrl = lane(ss.ctrl_cycles, 3)
            lat_wl = lane(ss.lat_wl, 3)
            serv_wl_bv = lane(ss.serv_wl, 3)
        lat_t = torch.where(out_is_wl, lat_wl, take(ss.b_lat, ob_c)) \
            + torch.where(first_wl & ~lane(ss.wl_rx_busy, 3), ctrl, 0)
        serv_t = torch.where(out_is_wl, serv_wl_bv, take(ss.b_serv, ob_c)) \
            + torch.where(first_wl, ctrl, 0)

        sv = src_of.clamp(0, NC - 1).long()
        ident = (src_of >= 0) & (take(obf, sv) == b_ids[:, None]) \
            & (take(out_vc.reshape(G, -1), sv) == vcol)
        if mc_on:
            # unicast identity: the upstream slot still targets me at my
            # VC; multicast copy identity: my feeder is a multicast air
            # sender of my own group (one transmission, every copy fed)
            mc_sv = take(is_mc.reshape(G, -1), sv)
            ident = ((src_of >= 0) & mc_sv & ss.b_is_rx[..., None]
                     & (mc_id >= 0)
                     & (take(mc_id.reshape(G, -1), sv) == mc_id)) \
                | (ident & ~mc_sv)
        incoming_any = ident & take(fwd.reshape(G, -1), sv)       # [G,B,V]
        if phy_on:
            # failing attempts occupy the channel and the receiver but
            # deliver nothing; a dropped packet's receiver VC is freed
            incoming = ident & take(
                (fwd & ~(out_is_wl & fail_bv)).reshape(G, -1), sv)
            rx_dropped = ident & take(drop.reshape(G, -1), sv)
        else:
            incoming = incoming_any
        d_in = (take(lat_t.reshape(G, -1), sv) - 1).clamp(0, DMAX - 1)
        pipe = pipe + (incoming[..., None] & (
            d.d_ar == d_in[..., None])).to(pipe.dtype)
        # crossbar: wireless winners do not serialize the receiver
        ser_in = incoming_any & (~take(out_is_wl.reshape(G, -1), sv)
                                 | lane(ss.wl_rx_busy, 3))
        serv_in = take(serv_t.reshape(G, -1), sv)
        busy_until = torch.where(
            ser_in.any(-1),
            t + _sum_i32(torch.where(ser_in, serv_in, 0), -1), st.busy_until)
        wl_busy_until = torch.where(
            is_wl_fwd.flatten(1).any(-1),
            t + torch.where(is_wl_fwd, serv_t, 0).amax((1, 2)),
            st.wl_busy_until)
        counted = _air_counted(ss, incoming, mc_id, mcid_c, b_ids) \
            if mc_on else incoming
        counts_into = st.counts_into + post[:, None] * _sum_i32(counted, -1)
        count_switch = st.count_switch + post * _sum_i32(fwd, (1, 2))
        ctrl_count = st.ctrl_count + post * _sum_i32(first_wl, (1, 2))
        wl_tx_flits = st.wl_tx_flits + post * _sum_i32(is_wl_fwd, (1, 2))
        wl_rx_flits = st.wl_rx_flits + post * _sum_i32(
            incoming & ss.b_is_rx[..., None], (1, 2))
        if phy_on:
            phy.update(_air_block(
                ss, st, d, t, post, win2_wl, fwd, out_is_wl, wd_bv, fail_bv,
                drop, serv_t, pkt_src, pkt_idx, mem, mem_on, living,
                NCp1, BIGC))
        # the feeding packet's tail has been sent: the link is quiet again
        src_of = torch.where(ident & take(tail.reshape(G, -1), sv), -1, src_of)

        # free VCs whose tail left (phy: also ARQ-dropped senders and the
        # receiver VCs their claims held)
        freed = tail
        if phy_on:
            freed = tail | drop | rx_dropped
            src_of = torch.where(rx_dropped, -1, src_of)
        pkt_src = torch.where(freed, -1, pkt_src)
        out_vc = torch.where(freed, -1, out_vc)
        out_is_wl = torch.where(freed, False, out_is_wl)
        out_is_ej = torch.where(freed, False, out_is_ej)

        # ---- 3. injection -------------------------------------------------
        n_ar = d.n_ar
        qh = st.q_head.clamp(0, K - 1)                            # [G,N]
        head = n_ar * K + qh                                      # [G,N]
        birth_n = take(ss.births.reshape(G, -1), head)
        ib = ss.inj_buf                                           # [G,N]
        ifree = (take(pkt_src, ib) < 0) & classA                  # [G,N,V]
        ihas = ifree.any(-1)
        ivc = _first_true(ifree)
        # phase gate: a packet injects only once its phase is open
        ph_ok = (ss.n_phases == 0)[:, None] \
            | (take(ss.phases.reshape(G, -1), head) <= cur_phase[:, None])
        outst = mem.get("outst", st.outst)
        if mem_on:
            # reply slots are born when the bank model services their
            # request (rdy); requests gate on the in-flight window
            birth_n = torch.minimum(
                birth_n, take(mem["rdy"].reshape(G, -1), head))
            opq = take(ss.mem_op.reshape(G, -1), head)
            is_tx = (opq == 1) | (opq == 2)
            ph_ok &= ~is_tx | (outst < ss.max_outst[:, None])
        can_new = (st.inj_vc < 0) & (st.q_head < K) & (birth_n <= t) \
            & ihas & ph_ok
        dst_n = take(ss.dests.reshape(G, -1), head)
        if mc_on:
            # multicast slots encode the group as dests = -(1 + m); the
            # packet routes to the group's anchor and fans out at the air
            mcv_n = torch.where(dst_n < 0, -(dst_n + 1), -1)      # [G,N]
            dst_n = torch.where(
                dst_n < 0, take(ss.mc_route, mcv_n.clamp(0, M - 1)), dst_n)
        r_oo, r_ob, r_owo, r_owl, r_oej = _route_fields(
            ss, ss.src_switch, dst_n)

        # target side: injection buffers map 1:1 to sources (static inj_src)
        nb = ss.inj_src.clamp(0, N - 1)                           # [G,B]
        nb_l = nb.long()
        n_valid = ss.inj_src >= 0

        def gn(x):
            return take(x, nb_l)                                  # [G,B]

        icl = (n_valid & gn(can_new))[..., None] & (gn(ivc)[..., None] == vcol)

        def iupd(old, val_n):
            return torch.where(icl, gn(val_n)[..., None], old)

        pkt_src = torch.where(icl, nb[..., None], pkt_src)
        pkt_idx = iupd(pkt_idx, st.q_head)
        pkt_dst = iupd(pkt_dst, dst_n)
        born = iupd(born, birth_n)
        out_o = iupd(out_o, r_oo.to(i32))
        out_buf = iupd(out_buf, r_ob.to(i32))
        out_wo = iupd(out_wo, r_owo.to(i32))
        out_is_wl = iupd(out_is_wl, r_owl)
        out_is_ej = iupd(out_is_ej, r_oej)
        out_vc = torch.where(icl, -1, out_vc)
        phase2 = torch.where(icl, False, phase2)
        if mc_on:
            mc_id = iupd(mc_id, mcv_n)
        attempt = torch.where(icl, 0, attempt)
        rcvd = torch.where(icl, 0, rcvd)
        sent = torch.where(icl, 0, sent)
        src_of = torch.where(icl, -1, src_of)
        inj_vc = torch.where(can_new, ivc.to(i8), st.inj_vc)
        inj_pushed = torch.where(can_new, 0, st.inj_pushed)
        q_head = st.q_head + can_new.to(i32)
        if mem_on and phy_on:
            # tombstoned reply slots (request ARQ-dropped) never birth:
            # step past them so the in-order channel keeps flowing
            skip = (st.inj_vc < 0) & (st.q_head < K) \
                & take(mem["dead"].reshape(G, -1), head)
            q_head = q_head + skip.to(i32)
        if mem_on:
            outst = outst + (can_new & is_tx).to(i32)
            mem["outst"] = outst
            mem["outst_peak"] = torch.maximum(st.outst_peak, outst)

        # push one flit/cycle/core while there is space (cores write straight
        # into their injection buffer — no pipe, so no src_of either)
        iv_c = inj_vc.clamp(0, V - 1)
        islot = ib * V + iv_c
        iocc = take(rcvd.reshape(G, -1), islot) - take(sent.reshape(G, -1), islot)
        can_push = (inj_vc >= 0) & (iocc < take(ss.b_depth, ib))
        pushc = (n_valid & gn(can_push))[..., None] & (gn(iv_c)[..., None] == vcol)
        rcvd = rcvd + pushc.to(i32)
        inj_pushed = inj_pushed + can_push.to(inj_pushed.dtype)
        flits_inj = st.flits_inj + post * _sum_i32(can_push, -1)
        # the source's current packet sits at q_head - 1 (claims advance
        # the head); its per-slot length ends the push burst
        if mem_on:
            plen_cur = take(ss.lens.reshape(G, -1),
                            n_ar * K + (q_head - 1).clamp(0, K - 1))
        else:
            plen_cur = ss.pkt_len[:, None]
        done = can_push & (inj_pushed >= plen_cur)
        inj_vc = torch.where(done, -1, inj_vc)

        # ---- 4. receiver wake/sleep accounting ([17]) ---------------------
        rx_got = take(arrive.sum(-1), d.rx_ids) > 0
        rx_busy = take(busy_until, d.rx_ids) > t
        rx_active = (rx_got | rx_busy) & d.rx_live
        n_rx_on = _sum_i32(rx_active, -1)
        awake = torch.where(ss.sleepy, n_rx_on, ss.n_wi)
        awake_cycles = st.awake_cycles + post * awake
        sleep_cycles = st.sleep_cycles + post * (ss.n_wi - awake)

        return st._replace(
            pkt_src=pkt_src, pkt_idx=pkt_idx, pkt_dst=pkt_dst, born=born,
            out_o=out_o, out_buf=out_buf, out_wo=out_wo, out_is_wl=out_is_wl,
            out_is_ej=out_is_ej, out_vc=out_vc, phase2=phase2,
            rcvd=rcvd, sent=sent, src_of=src_of, mc_id=mc_id,
            attempt=attempt, pipe=pipe, busy_until=busy_until,
            wl_busy_until=wl_busy_until,
            q_head=q_head, inj_vc=inj_vc, inj_pushed=inj_pushed,
            cur_phase=cur_phase, phase_del=phase_del, phase_end=phase_end,
            phase_flits=phase_flits,
            flits_inj=flits_inj, flits_del=flits_del, pkts_del=pkts_del,
            lat_sum=lat_sum, lat_pkts=lat_pkts, counts_into=counts_into,
            count_switch=count_switch, ctrl_count=ctrl_count,
            wl_tx_flits=wl_tx_flits, wl_rx_flits=wl_rx_flits,
            awake_cycles=awake_cycles, sleep_cycles=sleep_cycles,
            **mem, **phy,
        )

    return step


def _group_link(rows, member):
    """Broadcast ARQ's group link: per slot, the worst (largest) service
    time or PER threshold over its group's member links.  ``rows`` [G, B,
    W] are the sender WI's table rows, ``member`` [G, B, V, W] the slots'
    member masks; non-members count as 0."""
    return torch.where(member, rows[:, :, None, :], 0).amax(-1)


def _air_block(ss: SimStatic, st: SimState, d: Derived, t: int, post,
               win2_wl, fwd, out_is_wl, wd_bv, fail_bv, drop, serv_t,
               pkt_src, pkt_idx, mem: dict, mem_on: bool, living: bool,
               NCp1: int, BIGC: int) -> dict:
    """Per-(src WI, dst WI) pacing, air and energy counters of one cycle
    (``phy_on``), scatter-free: the (sub-channel, receiver) air winner is
    unique, so each pair sees at most one transmission per cycle — a
    masked one-assignment over the [W, W] grid.  A multicast winner shows
    in every member receiver's column; it is counted once, on its routed
    (sender, anchor) pair.  Under ``living`` the attempts also split by
    the pair's current rate entry; under ``mem_on`` a dropped request or
    reply credits its requester's window back, a dropped request
    tombstones its reply slot (``mem["outst"]``/``mem["dead"]`` are
    updated), and lost read round trips are counted.  Returns the updated
    leaves."""
    G = fwd.shape[0]
    N, K = ss.births.shape[1], ss.births.shape[2]
    warr = d.warr
    ws_ids = warr.to(i32)[:, None]                                # [W,1]
    r_ids = (ws_ids % ss.rxw.clamp(min=1)[:, None, None]).clamp(
        0, RXWMAX - 1)                                            # [G,W,1]
    w2 = take2(win2_wl, r_ids.expand(G, WMAX, WMAX),
               warr.expand(G, WMAX, WMAX))                        # [G,W,W]
    v2 = w2 < BIGC
    slot2 = torch.where(v2, w2 % NCp1, 0).long()

    def at(x):               # per-slot field of each pair's winner
        return take(x.reshape(G, -1), slot2)

    txp = v2 & at(fwd) & at(out_is_wl)         & (take(ss.b_wi, slot2 // V) == ws_ids) & (at(wd_bv) == warr)
    failp = txp & at(fail_bv)
    out = dict(
        pair_busy=torch.where(txp, t + at(serv_t), st.pair_busy),
        wl_pair_flits=st.wl_pair_flits + post[:, None, None] * txp.to(i32),
        wl_fail_flits=st.wl_fail_flits + post[:, None, None] * failp.to(i32))
    if living:
        # per-rate-entry attempt counters, attributed to the anchor pair's
        # current entry (the pair's entry moves mid-run)
        R = st.wl_rate_flits.shape[1]
        rhot = torch.arange(R, dtype=i32, device=txp.device)[
            :, None, None] == st.wl_rate_d[:, None]               # [G,R,W,W]
        pc = post[:, None]
        out.update(
            wl_rate_flits=st.wl_rate_flits + pc * _sum_i32(
                rhot & txp[:, None], (2, 3)),
            wl_rate_fail=st.wl_rate_fail + pc * _sum_i32(
                rhot & failp[:, None], (2, 3)))
    if mem_on:
        # every drop is an air-pair winner, so the grid sees each once
        d_on = txp & at(drop)
        nd = at(pkt_src).clamp(0, N - 1)
        kd = at(pkt_idx).clamp(0, K - 1)
        opd = torch.where(d_on, take2(ss.mem_op, nd, kd), 0)
        is_rqd = (opd == 1) | (opd == 2)
        is_repd = (opd == 3) | (opd == 4)
        tgt_d = torch.where(
            is_rqd, nd, torch.where(
                is_repd, take2(ss.req_src, nd, kd).clamp(0, N - 1), -1))
        n_ids = torch.arange(N, dtype=i32, device=tgt_d.device)
        mem["outst"] = mem["outst"] - _sum_i32(
            tgt_d[:, None] == n_ids[None, :, None, None], (2, 3))
        rrd = take2(ss.reply_row, nd, kd).clamp(0, N - 1)
        rsd = take2(ss.reply_slot, nd, kd).clamp(0, K - 1)
        dflat = torch.where(is_rqd, rrd * K + rsd, -1).reshape(G, 1, -1)
        hit = (torch.arange(N * K, dtype=i32, device=dflat.device)[
            None, :, None] == dflat).any(-1)                      # [G,N*K]
        mem["dead"] = st.dead | hit.reshape(G, N, K)
        out["mem_drop_reads"] = st.mem_drop_reads + post * _sum_i32(
            d_on & ((opd == 1) | (opd == 3)), (1, 2))
    return out


def _air_counted(ss: SimStatic, incoming, mc_id, mcid_c, b_ids):
    """The arrivals that count a link traversal (and so its energy).

    Transmit energy is paid once per broadcast: of a multicast's copies in
    the member rx buffers only the group's primary copy (lowest member WI)
    counts the air traversal.  Every other arrival counts.
    """
    prim_buf = ss.rx0[:, None, None] + take(ss.mc_prim, mcid_c)
    return incoming & ~((mc_id >= 0) & ss.b_is_rx[..., None]
                        & (b_ids[:, None] != prim_buf))


def _memory_block(ss: SimStatic, st: SimState, t: int, post, pkt_src,
                  pkt_idx, tail, tail_ej, win2_ej, psrc_c, pidx_c,
                  NCp1: int, BIGC: int) -> dict:
    """The closed-loop memory terms of one cycle (``mem_on``).

    (a) Request arrivals: the ejection winner at (stack switch, way =
    channel) is the unique request entering (stack, ch) this cycle; its
    bank starts service at ``max(t + 1, bank_busy)`` for ``t_row_hit`` or
    ``t_row_miss`` cycles, and the completion cycle is written into the
    paired reply slot's ``rdy`` by a one-assignment minimum (a gather over
    the [Y, CH] winners, no scatter).  (b) Reply and ack tails ejecting at
    the requester: AMAT, and the ``outst`` credit, found through the
    per-(switch, way) ejection winners.  Returns the updated leaves.
    """
    G, N, K = ss.births.shape
    S = ss.next_out.shape[1]
    Yp, CH, BKp = st.bank_busy.shape[1:]
    psrcf = pkt_src.reshape(G, -1)
    pidxf = pkt_idx.reshape(G, -1)
    tailf = tail.reshape(G, -1)
    stack_c = ss.stack_sw.clamp(0, S - 1)                        # [G,Y]
    code_yc = torch.gather(
        win2_ej, 2, stack_c[:, None, :].expand(G, CH, Yp).long()
    ).transpose(1, 2)                                            # [G,Y,CH]
    valid = code_yc < BIGC
    slot_yc = torch.where(valid, code_yc % NCp1, 0).long()
    n_w = take(psrcf, slot_yc).clamp(0, N - 1)
    k_w = take(pidxf, slot_yc).clamp(0, K - 1)
    opw = torch.where(valid & take(tailf, slot_yc),
                      take2(ss.mem_op, n_w, k_w), 0)             # [G,Y,CH]
    is_rq = (opw == 1) | (opw == 2)
    bank_w = take2(ss.mem_bank, n_w, k_w).clamp(0, BKp - 1)
    row_w = take2(ss.mem_row, n_w, k_w)
    bsel = bank_w.long()[..., None]
    bb = torch.gather(st.bank_busy, 3, bsel)[..., 0]
    br = torch.gather(st.bank_row, 3, bsel)[..., 0]
    hit = is_rq & (br == row_w)
    svc = torch.where(hit, ss.t_row_hit[:, None, None],
                      ss.t_row_miss[:, None, None])
    start = torch.clamp(bb, min=t + 1)
    done = start + svc                                           # [G,Y,CH]
    oneh = torch.arange(BKp, device=bank_w.device) == bank_w[..., None]
    updm = is_rq[..., None] & oneh
    bank_busy = torch.where(updm, done[..., None], st.bank_busy)
    bank_row = torch.where(updm, row_w[..., None], st.bank_row)
    # reply birth: one-assignment minimum into the paired slot's rdy
    rrow = take2(ss.reply_row, n_w, k_w).clamp(0, N - 1)
    rslot = take2(ss.reply_slot, n_w, k_w).clamp(0, K - 1)
    rflat = torch.where(is_rq, rrow * K + rslot, -1).reshape(G, 1, -1)
    m_rdy = torch.arange(N * K, dtype=i32,
                         device=rflat.device)[None, :, None] == rflat
    val = torch.where(m_rdy, done.reshape(G, 1, -1),
                      int(NO_PKT)).amin(-1)                      # [G,N*K]
    rdy = torch.minimum(st.rdy, val.reshape(G, N, K))
    # per-stack service stats
    rd_w = is_rq & (opw == 1)
    wr_w = is_rq & (opw == 2)
    pc = post[:, None]
    postf = pc.to(f32)
    data_w = torch.where(rd_w, take2(ss.lens, rrow, rslot),
                         torch.where(wr_w, take2(ss.lens, n_w, k_w), 0))
    # (b) reply/ack completion at the requester: AMAT + credit
    op_all = take2(ss.mem_op, psrc_c, pidx_c)                    # [G,B,V]
    is_rep = tail_ej & ((op_all == 3) | (op_all == 4))
    rb = take2(ss.req_birth, psrc_c, pidx_c)
    amat_ok = is_rep & (op_all == 3) & (rb >= ss.warmup[:, None, None])
    # the requester's switch saw at most one ejection tail per way; check
    # each winner against req_src
    src_c = ss.src_switch.clamp(0, S - 1)                        # [G,N]
    code_ns = torch.gather(
        win2_ej, 2, src_c[:, None, :].expand(G, win2_ej.shape[1], N).long())
    v_ns = code_ns < BIGC                                        # [G,EJ,N]
    slot_ns = torch.where(v_ns, code_ns % NCp1, 0).long()
    rep_ns = v_ns & take(is_rep.reshape(G, -1), slot_ns)
    req_ns = take2(ss.req_src, take(psrcf, slot_ns).clamp(0, N - 1),
                   take(pidxf, slot_ns).clamp(0, K - 1))
    n_ids = torch.arange(N, dtype=i32, device=req_ns.device)
    dec = _sum_i32(rep_ns & (req_ns == n_ids), 1)                # [G,N]
    return dict(
        rdy=rdy, bank_busy=bank_busy, bank_row=bank_row,
        outst=st.outst - dec,
        mem_reads=st.mem_reads + pc * _sum_i32(rd_w, -1),
        mem_writes=st.mem_writes + pc * _sum_i32(wr_w, -1),
        mem_row_hits=st.mem_row_hits + pc * _sum_i32(hit, -1),
        mem_q_sum=st.mem_q_sum + postf * torch.where(
            is_rq, (start - (t + 1)).to(f32), 0.0).sum(-1),
        mem_svc_sum=st.mem_svc_sum + postf * torch.where(
            is_rq, svc.to(f32), 0.0).sum(-1),
        mem_flits=st.mem_flits + pc * _sum_i32(data_w, -1),
        amat_sum=st.amat_sum + post * torch.where(
            amat_ok, (t - rb + 1).to(f32), 0.0).sum((1, 2)),
        amat_pkts=st.amat_pkts + post * _sum_i32(amat_ok, (1, 2)),
    )


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def _has_groups(ss: SimStatic) -> bool:
    """``mc_on`` for lanes ``ss``: does any lane's table hold a multicast
    group (one host sync)."""
    return bool(ss.mc_member.any())


def run_cycles(ss: SimStatic, st: SimState, t0: int, t1: int, B: int,
               mem_on: bool = False, phy_on: bool = False,
               drift_on: bool = False, reselect: bool = False) -> SimState:
    """Step lane-leading ``st`` through cycles ``[t0, t1)``, no freeze.

    The monolithic driver's loop, also used to continue from a carried
    state (``repro_torch.carry``).  The flags as in ``make_step``; the
    multicast terms run when any lane has a multicast group.  Living
    points get their window updates inside the step.
    """
    step = make_step(B, mem_on, phy_on, drift_on, reselect,
                     mc_on=_has_groups(ss))
    d = derive(ss, B)
    with torch.no_grad():
        for t in range(t0, t1):
            st = step(ss, d, st, t)
    return st


def _scan_point(ss: SimStatic, st: SimState, cycles: int, B: int,
                **flags) -> SimState:
    """Monolithic driver: every lane steps exactly ``cycles`` cycles.

    Kept as a differential oracle for the chunked driver.
    """
    st = run_cycles(ss, st, 0, cycles, B, **flags)
    c = torch.full_like(st.cycles_run, cycles)
    return st._replace(cycles_run=c, drain_cycle=c.clone())


# --------------------------------------------------------------------------
# host-side packing
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedSim:
    ss: SimStatic
    B: int
    n_cores: int
    Lw: int
    n_inj: int
    topo: Topology
    rt: RoutingTables
    phy: PhyParams
    sim: SimParams
    dims: dict = dataclasses.field(default_factory=dict)
    mem_on: bool = False      # closed-loop memory path in the step
    mc_on: bool = False       # the table has multicast groups
    phy_on: bool = False      # lossy-channel ARQ path in the step
    drift_on: bool = False    # living channel: SNR aging walk
    reselect: bool = False    # living channel: in-scan rate re-selection
    phy_link: object = None   # phy.PhyLinkInfo (host-side, for metrics)

    def flags(self) -> dict:
        """The static flags of the reference's step program."""
        return dict(mem_on=self.mem_on, phy_on=self.phy_on,
                    drift_on=self.drift_on, reselect=self.reselect)

    def shape_key(self) -> tuple:
        """Hashable signature of the step program and of every padded
        array shape (batch grouping).

        ``mem_on``, ``phy_on``, ``drift_on`` and ``reselect`` are part of
        the key as in the reference: each selects another step program
        (the placeholder shapes alone cannot tell the two living flags
        apart).  So is ``mc_on``, the port's own: a point without
        multicast groups keeps the open-loop program even when it shares
        its dims with a multicast trace.
        """
        return tuple(self.flags().items()) + (("mc_on", self.mc_on),) \
            + tuple((k, tuple(v.shape)) for k, v in self.ss._asdict().items())


def pack_dims(topo: Topology, tt: TrafficTable,
              b_bucket: int = 64, s_bucket: int = 8, r_bucket: int = 64,
              k_bucket: int = 32) -> dict:
    """Natural (floor-less) padded dims of a point, without packing it.

    Must mirror the dim arithmetic in ``pack``.
    """
    Lw = topo.n_links
    n_inj = tt.n_sources
    n_wi = topo.n_wi
    Wp = len(topo.wl_pairs)
    # buffers into each switch: wired link dsts + injection dsts + rx dsts
    b_dst_real = np.concatenate([
        topo.link_dst.astype(np.int64),
        tt.src_switch.astype(np.int64),
        topo.wi_switch.astype(np.int64)])
    indeg = np.bincount(b_dst_real, minlength=topo.n_switches)
    cr_max = 0
    if n_wi:
        senders = [set() for _ in range(n_wi)]
        for src_wi, dst_wi in topo.wl_pairs:
            senders[int(dst_wi)].add(int(topo.wi_switch[int(src_wi)]))
        # buffer lists are disjoint per switch, so candidate counts add up
        cr_max = max((int(sum(indeg[s] for s in sw)) for sw in senders),
                     default=0)
    dram = getattr(tt, "dram", None)
    return {
        "B": _bucket(Lw + n_inj + n_wi, b_bucket),
        "S": _bucket(topo.n_switches + 1, s_bucket),
        "R": _bucket(Lw + Wp + topo.n_switches, r_bucket),
        "K": _bucket(tt.k, k_bucket),
        "CS": _bucket(int(indeg.max(initial=1)), 4),
        "CR": _bucket(max(cr_max, 1), 16),
        "M": _bucket(getattr(tt, "n_mc", 0), 8),
        "P": _bucket(getattr(tt, "n_phases", 0), 8),
        "Y": _bucket(topo.n_mem, 4),
        "BK": _bucket(dram.n_banks if dram is not None else 1, 8),
    }


def pack(topo: Topology, rt: RoutingTables, tt: TrafficTable,
         phy: PhyParams, sim: SimParams,
         b_bucket: int = 64, s_bucket: int = 8, r_bucket: int = 64,
         k_bucket: int = 32, floors: dict | None = None,
         phy_spec=None, device=None) -> PackedSim:
    """Pack a (topology, routing, traffic) point into padded tensors.

    The host arithmetic is the reference's, in numpy; the tables move to
    ``device`` at the end.  ``floors`` raises padded dims so heterogeneous
    points share one shape (padding is semantically inert).  Trace tables
    (phases, multicast groups) and memory tables (closed-loop
    request/reply) pack as in the reference.  ``phy_spec`` (a
    ``phy.PhySweepSpec``) turns on the lossy-channel ARQ path on fabrics
    with wireless interfaces, and with drift or re-selection the living
    channel; wireline fabrics (and ``phy_spec=None``) pack the exact
    ideal-channel program.
    """
    from repro_torch.phy.rates import pack_link_state
    dev = _device.resolve(device)
    fl = floors or {}
    Lw = topo.n_links
    n_inj = tt.n_sources
    n_wi = topo.n_wi
    B = max(_bucket(Lw + n_inj + n_wi, b_bucket), fl.get("B", 0))
    S = max(_bucket(topo.n_switches + 1, s_bucket), fl.get("S", 0))
    Wp = len(topo.wl_pairs)
    R = max(_bucket(Lw + Wp + topo.n_switches, r_bucket), fl.get("R", 0))
    medium = phy.wireless_medium
    RXW = max(1, int(phy.wireless_rx_streams)) if medium == "crossbar" else 1
    assert RXW <= RXWMAX, \
        f"wireless_rx_streams={RXW} exceeds simulator cap {RXWMAX}"
    N = n_inj
    K = max(_bucket(tt.k, k_bucket), fl.get("K", 0))
    assert n_wi <= WMAX

    # per-buffer attributes
    b_dst = np.full(B, S - 1, np.int32)
    b_serv = np.ones(B, np.int32)
    b_lat = np.ones(B, np.int32)
    b_epb = np.zeros(B, np.float32)
    b_depth = np.full(B, DEPTH, np.int32)
    b_wi = np.full(B, -1, np.int32)
    b_is_rx = np.zeros(B, bool)
    b_ej_ways = np.ones(B, np.int32)
    b_src_sw = np.full(B, S - 1, np.int32)
    inj_src = np.full(B, -1, np.int32)

    cls = topo.link_cls
    pipe_stages = phy.switch_stages
    serv_map = {
        int(LinkClass.MESH): 1,
        int(LinkClass.INTERPOSER): phy.interposer_flit_cycles,
        int(LinkClass.SERIAL): phy.serial_flit_cycles,
        int(LinkClass.WIDEIO): phy.wideio_flit_cycles,
    }
    for l in range(Lw):
        c = int(cls[l])
        b_dst[l] = topo.link_dst[l]
        b_src_sw[l] = topo.link_src[l]
        b_serv[l] = serv_map[c]
        b_lat[l] = pipe_stages + serv_map[c]
        mm = float(topo.link_mm[l])
        if c == int(LinkClass.MESH):
            b_epb[l] = phy.e_wire_pj_bit_mm * mm
        elif c == int(LinkClass.INTERPOSER):
            b_epb[l] = phy.e_wire_pj_bit_mm * mm + phy.e_ubump_pj_bit
        elif c == int(LinkClass.SERIAL):
            b_epb[l] = phy.e_serial_pj_bit
        elif c == int(LinkClass.WIDEIO):
            b_epb[l] = phy.e_wideio_pj_bit
    for n in range(n_inj):
        b = Lw + n
        b_dst[b] = tt.src_switch[n]
        inj_src[b] = n
    rx0 = Lw + n_inj
    serv_wl = phy.wireless_flit_cycles
    for w in range(n_wi):
        b = rx0 + w
        b_dst[b] = topo.wi_switch[w]
        b_lat[b] = pipe_stages + serv_wl
        b_epb[b] = phy.e_wireless_pj_bit
        b_is_rx[b] = True
    # sender WI of any buffer whose switch hosts a WI
    for b in range(rx0 + n_wi):   # rx buffers may relay (phase-2 hops)
        w = topo.wi_of_switch[b_dst[b]] if b_dst[b] < topo.n_switches else -1
        b_wi[b] = w
    # 4-channel memory stacks eject up to 4 flits/cycle
    for b in range(B):
        if b_dst[b] < topo.n_switches and topo.is_mem[b_dst[b]]:
            b_ej_ways[b] = EJ_WAYS
    if sim.mac == MacMode.TOKEN and n_wi:
        # token MAC [7] transmits whole packets only => WI-adjacent buffers
        # must hold a full packet (§III.D)
        wi_set = set(int(x) for x in topo.wi_switch)
        for b in range(rx0):
            if int(b_dst[b]) in wi_set:
                b_depth[b] = max(int(b_depth[b]), phy.pkt_flits)

    # lossy PHY: per-(src, dst)-WI rate/PER tables, inert without a spec
    # or without a wireless medium; the helper deepens buffers and zeroes
    # the rx buffers' epb, and sets rx_hold (store-and-forward receivers)
    # also for tables with multicast groups
    pli, phy_on, rx_hold = pack_link_state(
        topo, phy, tt, phy_spec, b_dst, b_depth, b_epb, rx0)
    # living channel: SNR drift and/or in-scan re-selection embed the
    # per-entry tables; static points keep (1, 1) placeholders
    drift_on = bool(phy_on and phy_spec.drift_amp_db > 0.0)
    reselect = bool(phy_on and phy_spec.reselect)
    living = drift_on or reselect

    # arbitration candidate tables: buffers feeding each switch ...
    in_bufs: list[list[int]] = [[] for _ in range(S)]
    for b in range(rx0 + n_wi):
        if b_dst[b] < topo.n_switches:
            in_bufs[int(b_dst[b])].append(b)
    CS = max(_bucket(max((len(x) for x in in_bufs), default=1), 4),
             fl.get("CS", 0))
    cands = np.full((S, CS), B, np.int32)
    for s in range(topo.n_switches):
        cands[s, :len(in_bufs[s])] = in_bufs[s]
    # ... and buffers able to transmit to each wireless receiver
    senders: list[list[int]] = [[] for _ in range(WMAX)]
    for p in range(Wp):
        src_wi = int(topo.wl_pairs[p, 0])
        dst_wi = int(topo.wl_pairs[p, 1])
        senders[dst_wi].append(int(topo.wi_switch[src_wi]))
    cr_lists = [sorted({b for s in set(sw) for b in in_bufs[s]})
                for sw in senders]
    CR = max(_bucket(max((len(x) for x in cr_lists), default=1), 16),
             fl.get("CR", 0))
    candr = np.full((WMAX, CR), B, np.int32)
    for w in range(n_wi):
        candr[w, :len(cr_lists[w])] = cr_lists[w]
    wi_sw = np.full(WMAX, S - 1, np.int32)
    wi_sw[:n_wi] = topo.wi_switch

    # routing lookup tables
    next_out = np.full((S, S), 0, np.int32)
    next_out[:topo.n_switches, :topo.n_switches] = rt.next_out
    o_buf = np.full(R, B, np.int32)
    o_wo = np.full(R, 0, np.int32)
    o_is_wl = np.zeros(R, bool)
    o_is_ej = np.zeros(R, bool)
    for o in range(Lw):
        o_buf[o] = o
        o_wo[o] = o               # wired arbitration key: the link itself
    for p in range(Wp):
        o = Lw + p
        dst_wi = int(topo.wl_pairs[p, 1])
        o_buf[o] = rx0 + dst_wi
        o_wo[o] = dst_wi          # wireless arbitration key: the receiver
        o_is_wl[o] = True
    for s in range(topo.n_switches):
        o = Lw + Wp + s
        o_wo[o] = s               # ejection arbitration key: the switch
        o_is_ej[o] = True
    assert rt.n_outputs == Lw + Wp + topo.n_switches

    births = np.full((N, K), NO_PKT, np.int32)
    births[:, :tt.k] = tt.births
    dests = np.zeros((N, K), np.int32)
    dests[:, :tt.k] = tt.dests

    # trace tables: phase barriers + multicast groups (all-zero semantics
    # for the synthetic open-loop generators)
    Pn = tt.n_phases
    Mn = tt.n_mc
    P = max(_bucket(Pn, 8), fl.get("P", 0))
    M = max(_bucket(Mn, 8), fl.get("M", 0))
    phases = np.zeros((N, K), np.int32)
    phase_need = np.zeros(P, np.int32)
    mc_member = np.zeros((M, WMAX), bool)
    mc_dst = np.zeros((M, WMAX), np.int32)
    mc_route = np.zeros(M, np.int32)
    mc_prim = np.zeros(M, np.int32)
    if Pn:
        phases[:, :tt.k] = tt.phases
        phase_need[:Pn] = tt.phase_need
    if Mn:
        mc_member[:Mn] = tt.mc_member
        mc_dst[:Mn] = np.clip(tt.mc_dst, 0, None)    # -1 pad, member-masked
        mc_route[:Mn] = tt.mc_route
        mc_prim[:Mn] = np.argmax(tt.mc_member, axis=1)
        assert tt.mc_member.shape[1] == WMAX
        assert tt.mc_member[:Mn].any(axis=1).all(), "empty multicast group"

    # memory tables (closed-loop request/reply; inert for open-loop tables)
    mem_on = getattr(tt, "mem_op", None) is not None
    dram = (getattr(tt, "dram", None) or DEFAULT_DRAM) if mem_on \
        else DEFAULT_DRAM
    Y = max(_bucket(topo.n_mem, 4), fl.get("Y", 0))
    BK = max(_bucket(dram.n_banks if mem_on else 1, 8), fl.get("BK", 0))
    NK = (N, K)
    lens = np.full(NK, phy.pkt_flits, np.int32)
    mem = {k: np.zeros(NK, np.int32)
           for k in ("mem_op", "mem_ch", "mem_bank", "mem_row")}
    mem.update({k: np.full(NK, -1, np.int32)
                for k in ("reply_row", "reply_slot", "req_src")})
    mem["req_birth"] = np.full(NK, NO_PKT, np.int32)
    if mem_on:
        assert dram.n_banks <= BK
        lens[:, :tt.k] = tt.lens
        for k in mem:
            mem[k][:, :tt.k] = getattr(tt, k)
    stack_sw = np.full(Y, S - 1, np.int32)
    stack_sw[:topo.n_mem] = np.nonzero(topo.is_mem)[0]
    max_outst = dram.max_outstanding if mem_on else 2**30

    def i32s(x):
        return np.int32(x)

    fields = dict(
        b_dst=b_dst, b_serv=b_serv, b_lat=b_lat, b_epb=b_epb,
        b_depth=b_depth, b_wi=b_wi, b_is_rx=b_is_rx, b_ej_ways=b_ej_ways,
        b_src_sw=b_src_sw, inj_src=inj_src,
        next_out=next_out, o_buf=o_buf, o_wo=o_wo, o_is_wl=o_is_wl,
        o_is_ej=o_is_ej, cands=cands, candr=candr, wi_sw=wi_sw,
        rxw=i32s(RXW), n_wi=i32s(n_wi), rx0=i32s(rx0),
        inj_buf=(Lw + np.arange(N, dtype=np.int32)).astype(np.int32),
        src_switch=tt.src_switch.astype(np.int32),
        births=births, dests=dests,
        pkt_len=i32s(phy.pkt_flits), warmup=i32s(sim.warmup),
        cycles=i32s(sim.cycles), serv_wl=i32s(serv_wl),
        lat_wl=i32s(pipe_stages + serv_wl),
        ctrl_cycles=i32s(max(1, phy.ctrl_packet_flits * serv_wl)),
        mac_token=np.bool_(sim.mac == MacMode.TOKEN),
        wl_sender_cap=np.bool_(medium != "crossbar"),
        wl_single=np.bool_(medium == "single"),
        wl_rx_busy=np.bool_(medium != "crossbar"),
        sleepy=np.bool_(bool(sim.sleepy_rx)),
        phases=phases, phase_need=phase_need, n_phases=i32s(Pn),
        mc_member=mc_member, mc_dst=mc_dst, mc_route=mc_route,
        mc_prim=mc_prim,
        lens=lens, **mem,
        stack_sw=stack_sw,
        t_row_hit=i32s(dram.t_row_hit), t_row_miss=i32s(dram.t_row_miss),
        max_outst=i32s(max_outst),
        wl_serv=pli.serv if phy_on else np.ones((WMAX, WMAX), np.int32),
        wl_perq=pli.perq if phy_on else np.zeros((WMAX, WMAX), np.int32),
        rx_hold=np.bool_(rx_hold),
        max_retx=i32s(phy_spec.max_retx if phy_on else 1),
        # the u32 seed held in int64: torch has no uint32 arithmetic
        phy_seed=np.int64(np.uint32(phy_spec.seed if phy_on else 0)),
        ctrl_flits=i32s(phy.ctrl_packet_flits),
        wl_rate0=pli.rate_idx if living else np.zeros((1, 1), np.int32),
        wl_snr=pli.snr_pad if living else np.zeros((1, 1), np.float32),
        wl_serv_r=pli.serv_r if living else np.ones(1, np.int32),
        wl_perq_r=pli.perq_r if living else np.zeros((1, 1, 1), np.int32),
        wl_gp_q=pli.gp_q if living else np.zeros((1, 1, 1), np.int32),
        wl_gain_r=pli.gain_r if living else np.ones(1, np.float32),
        wl_gbps_r=pli.gbps_r if living else np.ones(1, np.float32),
        wl_pkt_bits=np.float32(phy.pkt_flits * phy.flit_bits),
        wl_drift_amp=np.float32(phy_spec.drift_amp_db if phy_on else 0.0),
        wl_drift_period=i32s(max(1, phy_spec.drift_period)
                             if phy_on else 1),
    )
    ss = SimStatic(**{k: torch.from_numpy(np.asarray(v)).to(dev)
                      for k, v in fields.items()})
    dims = {"B": B, "S": S, "R": R, "K": K, "CS": CS, "CR": CR,
            "M": M, "P": P, "Y": Y, "BK": BK}
    return PackedSim(ss=ss, B=B, n_cores=topo.n_cores, Lw=Lw,
                     n_inj=n_inj, topo=topo, rt=rt, phy=phy, sim=sim,
                     dims=dims, mem_on=mem_on, mc_on=Mn > 0, phy_on=phy_on,
                     drift_on=drift_on, reselect=reselect, phy_link=pli)


# --------------------------------------------------------------------------
# batched execution
# --------------------------------------------------------------------------

def _state_dims(ps: PackedSim) -> tuple:
    """(B, N, P, K, Y, BK) for ``init_state`` from a packed point."""
    N, K = ps.ss.births.shape
    return (ps.B, int(N), int(ps.ss.phase_need.shape[0]), int(K),
            int(ps.ss.stack_sw.shape[0]), ps.dims.get("BK", 1))


def run_lanes(ss: SimStatic, st: SimState, B: int, budgets: Sequence[int],
              driver: str = "chunked", mem_on: bool = False,
              phy_on: bool = False, drift_on: bool = False,
              reselect: bool = False, chunk: int = CHUNK_CYCLES) -> SimState:
    """Drive lane-leading ``ss``/``st`` to each lane's budget.

    ``budgets`` are the lanes' ``ss.cycles`` on the host.
    ``driver="monolithic"`` runs the fixed-length oracle (one shared
    budget; living points get their window updates in the step alone;
    ``chunk`` is not used).  ``chunk`` is the chunked driver's execution
    chunk (``chunked.run_chunked``).  The flags as in ``make_step``; the
    multicast terms run when any lane has a multicast group.
    """
    flags = dict(mem_on=mem_on, phy_on=phy_on, drift_on=drift_on,
                 reselect=reselect)
    if driver == "monolithic":
        if len(set(budgets)) != 1:
            raise ValueError(
                "monolithic driver needs one shared cycle budget; got "
                f"{sorted(set(budgets))}")
        return _scan_point(ss, st, budgets[0], B, **flags)
    if driver != "chunked":
        raise ValueError(f"unknown driver {driver!r}")
    step = make_step(B, **flags, mc_on=_has_groups(ss))
    d = derive(ss, B)
    wfn = make_window_fn(ss, drift_on, reselect) \
        if (drift_on or reselect) else None
    with torch.no_grad():
        return chunked.run_chunked(
            lambda s, t: step(ss, d, s, t), ss, st, budgets, mem_on,
            window_fn=wfn, chunk=chunk)


def run_batch(pss: Sequence[PackedSim], cycles: int | None = None,
              driver: str = "chunked",
              chunk: int = CHUNK_CYCLES) -> SimState:
    """Run same-bucket-shape points as lanes of one lockstep batch.

    Returns a ``SimState`` whose leaves carry a leading lane axis, ordered
    as ``pss``.  Cycle budgets and warm-ups are per-lane data and may
    differ; ``cycles`` overrides every lane's budget.  Each lane's result
    equals a solo run of that point, bit for bit.  ``driver`` and
    ``chunk`` as in ``run_lanes``.
    """
    if not pss:
        raise ValueError("run_batch needs at least one point")
    key0 = pss[0].shape_key()
    for ps in pss[1:]:
        if ps.shape_key() != key0:
            raise ValueError(
                "run_batch requires identical padded shapes; got "
                f"{ps.dims} vs {pss[0].dims} — pack with harmonized floors")
    budgets = [int(cycles if cycles is not None else ps.sim.cycles)
               for ps in pss]
    ss = SimStatic(*(torch.stack(xs) for xs in zip(*(ps.ss for ps in pss))))
    ss = ss._replace(cycles=torch.tensor(budgets, dtype=i32,
                                         device=ss.cycles.device))
    ps0 = pss[0]
    st = init_state(*_state_dims(ps0), mem_on=ps0.mem_on,
                    phy_on=ps0.phy_on,
                    living=ps0.drift_on or ps0.reselect,
                    R=int(ps0.ss.wl_serv_r.shape[0]), lanes=len(pss),
                    device=ss.cycles.device)
    return run_lanes(ss, st, ps0.B, budgets, driver, **ps0.flags(),
                     chunk=chunk)


def run(ps: PackedSim, cycles: int | None = None, driver: str = "chunked",
        chunk: int = CHUNK_CYCLES) -> SimState:
    """Single-point API: a batch of one, returned without the lane axis."""
    out = run_batch([ps], cycles=cycles, driver=driver, chunk=chunk)
    return SimState(*(x[0] for x in out))


def run_from(ss: SimStatic, st: SimState, driver: str = "chunked",
             chunk: int = CHUNK_CYCLES, **flags) -> SimState:
    """Run one point from a given (e.g. carried) state, cycle 0 to
    ``ss.cycles``; ``ss``/``st`` and the result have no lane axis.
    ``flags`` (``mem_on``, ``phy_on``, ``drift_on``, ``reselect``) must be
    those the state was made with."""
    B = int(ss.b_dst.shape[0])
    out = run_lanes(SimStatic(*(x[None] for x in ss)),
                    SimState(*(x[None] for x in st)), B,
                    [int(ss.cycles)], driver, **flags, chunk=chunk)
    return SimState(*(x[0] for x in out))
