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
The open-loop, ideal-channel program of the reference step
(``mem_on = phy_on = drift_on = reselect = False``): all three wireless
media (crossbar, matching, single), both MAC modes (control packet,
token) and sleepy receivers.  ``pack`` raises ``NotImplementedError`` for
tables with memory ops, multicast groups or phases and for a
``phy_spec`` (ROADMAP A5-A7).  The multicast terms of the reference step
are therefore absent here: with no groups they are identically inert,
and ``mc_id`` stays at its ``init_state`` value.  The phase-barrier
bookkeeping is kept, because the open-loop step still writes
``phase_del``/``phase_flits``.

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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import chunked
from repro_torch.core.constants import (WMAX, LinkClass, MacMode, PhyParams,
                                        SimParams)
from repro_torch.core.routing import RoutingTables
from repro_torch.core.topology import Topology
from repro_torch.core.traffic import NO_PKT, TrafficTable
from repro_torch.memory.model import MEM_CH, DEFAULT_DRAM

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
    # lossy PHY tables (inert: the ARQ path is not ported)
    wl_serv: torch.Tensor      # [WMAX, WMAX]
    wl_perq: torch.Tensor      # [WMAX, WMAX]
    rx_hold: torch.Tensor      # bool: rx slots hold whole packets
    max_retx: torch.Tensor     # scalar i32
    phy_seed: torch.Tensor     # scalar u32
    ctrl_flits: torch.Tensor   # scalar i32
    # living-channel tables (placeholder shapes)
    wl_rate0: torch.Tensor
    wl_snr: torch.Tensor
    wl_serv_r: torch.Tensor
    wl_perq_r: torch.Tensor
    wl_gp_q: torch.Tensor
    wl_gain_r: torch.Tensor
    wl_gbps_r: torch.Tensor
    wl_pkt_bits: torch.Tensor
    wl_drift_amp: torch.Tensor
    wl_drift_period: torch.Tensor


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
    pair_busy: torch.Tensor    # placeholder (lossy PHY)
    # injection
    q_head: torch.Tensor       # [N]
    inj_vc: torch.Tensor       # [N] int8
    inj_pushed: torch.Tensor   # [N] int16
    # phase barrier
    cur_phase: torch.Tensor    # scalar
    phase_del: torch.Tensor    # scalar
    phase_end: torch.Tensor    # [P]
    phase_flits: torch.Tensor  # [P]
    # closed-loop memory (placeholders)
    rdy: torch.Tensor
    dead: torch.Tensor
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
    # lossy-PHY stats (placeholders / zero)
    wl_pair_flits: torch.Tensor
    wl_fail_flits: torch.Tensor
    wl_pkts: torch.Tensor
    wl_nacks: torch.Tensor
    pkts_dropped: torch.Tensor
    wl_drop_flits: torch.Tensor
    mem_drop_reads: torch.Tensor
    # living-channel dynamics (placeholders)
    wl_serv_d: torch.Tensor
    wl_perq_d: torch.Tensor
    wl_rate_d: torch.Tensor
    wl_resel: torch.Tensor
    wl_rate_flits: torch.Tensor
    wl_rate_fail: torch.Tensor
    # driver metadata
    cycles_run: torch.Tensor   # scalar i32
    drain_cycle: torch.Tensor  # scalar i32


def init_state(B: int, N: int, P: int = 1, Y: int = 1, *,
               lanes: int | None = None, device=None) -> SimState:
    """Zero state, leaf for leaf the reference's open-loop ``init_state``.

    The memory, PHY and living-channel leaves keep the reference's
    placeholder shapes for disabled paths.  ``lanes`` prepends a lane
    dimension of that size to every leaf.
    """
    dev = _device.resolve(device)
    pre = () if lanes is None else (lanes,)

    def full(shape, val, dtype):
        return torch.full(pre + tuple(shape), val, dtype=dtype, device=dev)

    def z(shape, dtype=i32):
        return full(shape, 0, dtype)

    NK = (1, 1)
    YCB = (1, 1, 1)
    WW = WWL = (1, 1)
    RL = (1,)
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
    way_ok = cs_ok[:, None] & (
        way_s[:, None] == torch.arange(EJ_WAYS, device=dev)[:, None, None,
                                                             None])
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
        idx_s=idx_s, way_ok=way_ok, sub_ok=sub_ok,
        idx_t=take(idx_s, wi_sw_c), cT_ok=take(cs_ok, wi_sw_c),
        way_bv=way_bv,
        r_mine=r_mine[:, :, None].expand(G, B, V),
        wi_c=ss.b_wi.clamp(0, WMAX - 1),
        rx_ids=(rx0 + warr).clamp(0, B - 1),
        rx_slot=(torch.arange(B, device=dev) - rx0).clamp(0, WMAX - 1),
        rx_live=warr < ss.n_wi[:, None],
        hold_bv=(ss.rx_hold[:, None] & ss.b_is_rx)[..., None],
        flat2d=torch.arange(B * V, dtype=i32, device=dev).reshape(B, V),
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
              drift_on: bool = False, reselect: bool = False):
    """Build the per-cycle transition ``step(ss, d, st, t) -> st``.

    ``ss``/``st`` are lane-leading; ``d = derive(ss, B)``; ``t`` is the
    cycle (a Python int, shared by all lanes).  Only the open-loop
    ideal-channel program exists in the port: any path flag raises.
    """
    if mem_on or phy_on or drift_on or reselect:
        raise NotImplementedError(
            "closed-loop memory / lossy PHY steps: ROADMAP A6-A7")
    NC = B * V
    NCp1 = NC + 1
    assert NC * (NC + 1) < 2**31, \
        f"B={B}: priority codes would overflow int32 (B*V must be < 46341)"
    BIGC = NC * NCp1

    def step(ss: SimStatic, d: Derived, st: SimState, t: int) -> SimState:
        G = st.pkt_src.shape[0]
        S = ss.next_out.shape[1]
        P = ss.phase_need.shape[1]
        N, K = ss.births.shape[1], ss.births.shape[2]
        flat2d, vcol, b_ids = d.flat2d, d.vcol, d.b_ids
        classA = vcol < V // 2

        def lane(x, nd):            # [G] per-lane scalar -> broadcastable
            return x.view((G,) + (1,) * (nd - 1))

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
        hold0_ok = ~d.hold_bv | (rcvd >= lane(ss.pkt_len, 3))
        need = active & (st.out_vc < 0) & ~st.out_is_ej & (occ > 0) \
            & (st.out_buf < B) & hold0_ok & has_free_c
        code = torch.where(need, prio, BIGC)                      # [G,B,V]
        codef = code.reshape(G, -1)
        obf0 = st.out_buf.reshape(G, -1)

        # winner (min code) per wired target buffer: contenders live at the
        # buffers feeding the target's transmitting switch
        m_w = d.cw_ok & (take(obf0, d.idx_w) == b_ids[:, None, None])
        win_code_w = torch.where(m_w, take(codef, d.idx_w),
                                 BIGC).amin((2, 3))               # [G,B]
        # winner per wireless rx target: contenders at sender WI switches
        m_r = d.cr_ok & (take(obf0, d.idx_r) == d.rx_tgt)
        win_code_r = torch.where(m_r, take(codef, d.idx_r),
                                 BIGC).amin((2, 3))               # [G,W]
        win_code = torch.where(ss.b_is_rx, take(win_code_r, d.rx_slot),
                               win_code_w)
        has_win = win_code < BIGC                                 # [G,B]
        wsrc = torch.where(has_win, win_code % NCp1, 0)           # flat slot
        wsrc_l = wsrc.long()
        win_uni = need & (take(win_code, ob_c0) == code)

        def g(a):            # winner's field per target buffer -> [G,B]
            return take(a.reshape(G, -1), wsrc_l)

        vfree_self = _first_true(free_mask)                       # [G,B]
        vstar = torch.where(ss.b_is_rx, vfree_self, g(first_free_c))
        claimed = has_win[..., None] & (vstar[..., None] == vcol)  # [G,B,V]
        dst_w = g(st.pkt_dst)
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
        attempt = torch.where(claimed, 0, st.attempt)
        rcvd = torch.where(claimed, 0, rcvd)
        sent = torch.where(claimed, 0, st.sent)
        src_of = upd(st.src_of, wsrc)
        # upstream learns its allocated VC
        out_vc = torch.where(win_uni, first_free_c.to(out_vc.dtype), out_vc)

        active = pkt_src >= 0
        occ = torch.where(active, rcvd - sent, 0)
        psrc_c = pkt_src.clamp(0, N - 1)
        pidx_c = pkt_idx.clamp(0, K - 1)
        plen = lane(ss.pkt_len, 3)

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
        elig = active & (occ > 0) & wl_ok & hold_ok \
            & (out_is_ej | ((out_vc >= 0) & (space > 0) & link_free))
        code2 = torch.where(elig, prio, BIGC)
        code2f = code2.reshape(G, -1)
        obf = out_buf.reshape(G, -1)

        # wired-output winners: one flit per link per cycle
        m2_w = d.cw_ok & (take(obf, d.idx_w) == b_ids[:, None, None])
        win2_w = torch.where(m2_w, take(code2f, d.idx_w), BIGC).amin((2, 3))
        # multi-channel ejection: one winner per (switch, way); a slot's
        # way is vc % b_ej_ways (memory stacks sink 4 flits/cycle)
        m_ej = take(out_is_ej.reshape(G, -1), d.idx_s)            # [G,S,CS,V]
        win2_ej = torch.where(d.way_ok & m_ej[:, None],
                              take(code2f, d.idx_s)[:, None],
                              BIGC).amin((3, 4))                  # [G,EJ,S]
        # wireless rx sub-channels: receiver w serves `rxw` concurrent
        # streams; a sender's stream is its WI id mod rxw
        m2_r = d.cr_ok & (take(obf, d.idx_r) == d.rx_tgt)         # [G,W,CR,V]
        win2_wl = torch.where(d.sub_ok & m2_r[:, None],
                              take(code2f, d.idx_r)[:, None],
                              BIGC).amin((3, 4))                  # [G,RXW,W]

        owo_s = out_wo.clamp(0, S - 1)                            # eject: switch
        owo_w = out_wo.clamp(0, WMAX - 1)                         # wl: dst WI
        win2_mine = torch.where(
            out_is_ej, take2(win2_ej, d.way_bv, owo_s),
            torch.where(out_is_wl, take2(win2_wl, d.r_mine, owo_w),
                        take(win2_w, ob_c)))
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

        # ---- phase barrier bookkeeping (raw counts; inert for open-loop
        # tables apart from the two running counters)
        phv = take2(ss.phases, psrc_c, pidx_c)                     # [G,B,V]
        cur = st.cur_phase
        phase_del = st.phase_del + _sum_i32(
            tail_ej & (phv == lane(cur, 3)), (1, 2))
        at_cur = d.parr == cur[:, None]                             # [G,P]
        phase_flits = st.phase_flits + torch.where(at_cur, n_ej[:, None], 0)
        in_trace = (ss.n_phases > 0) & (cur < ss.n_phases)
        needed = take(ss.phase_need, cur.clamp(0, P - 1))
        complete = in_trace & (phase_del >= needed)
        phase_end = torch.where(at_cur & complete[:, None], t + 1,
                                st.phase_end)
        cur_phase = cur + complete.to(i32)
        phase_del = torch.where(complete, 0, phase_del)

        # non-eject: deliver downstream via the src_of inverse map — each
        # target (buffer, vc) gathers from the unique upstream slot feeding
        # it (identity-checked against out_buf/out_vc to survive slot reuse)
        first_wl = is_wl_fwd & (sent == 1)   # header => control packet
        ctrl = lane(ss.ctrl_cycles, 3)
        lat_t = torch.where(out_is_wl, lane(ss.lat_wl, 3), take(ss.b_lat, ob_c)) \
            + torch.where(first_wl & ~lane(ss.wl_rx_busy, 3), ctrl, 0)
        serv_t = torch.where(out_is_wl, lane(ss.serv_wl, 3),
                             take(ss.b_serv, ob_c)) \
            + torch.where(first_wl, ctrl, 0)

        sv = src_of.clamp(0, NC - 1).long()
        ident = (src_of >= 0) & (take(obf, sv) == b_ids[:, None]) \
            & (take(out_vc.reshape(G, -1), sv) == vcol)
        incoming = ident & take(fwd.reshape(G, -1), sv)           # [G,B,V]
        d_in = (take(lat_t.reshape(G, -1), sv) - 1).clamp(0, DMAX - 1)
        pipe = pipe + (incoming[..., None] & (
            d.d_ar == d_in[..., None])).to(pipe.dtype)
        # crossbar: wireless winners do not serialize the receiver
        ser_in = incoming & (~take(out_is_wl.reshape(G, -1), sv)
                             | lane(ss.wl_rx_busy, 3))
        serv_in = take(serv_t.reshape(G, -1), sv)
        busy_until = torch.where(
            ser_in.any(-1),
            t + _sum_i32(torch.where(ser_in, serv_in, 0), -1), st.busy_until)
        wl_busy_until = torch.where(
            is_wl_fwd.flatten(1).any(-1),
            t + torch.where(is_wl_fwd, serv_t, 0).amax((1, 2)),
            st.wl_busy_until)
        counts_into = st.counts_into + post[:, None] * _sum_i32(incoming, -1)
        count_switch = st.count_switch + post * _sum_i32(fwd, (1, 2))
        ctrl_count = st.ctrl_count + post * _sum_i32(first_wl, (1, 2))
        wl_tx_flits = st.wl_tx_flits + post * _sum_i32(is_wl_fwd, (1, 2))
        wl_rx_flits = st.wl_rx_flits + post * _sum_i32(
            incoming & ss.b_is_rx[..., None], (1, 2))
        # the feeding packet's tail has been sent: the link is quiet again
        src_of = torch.where(ident & take(tail.reshape(G, -1), sv), -1, src_of)

        # free VCs whose tail left
        pkt_src = torch.where(tail, -1, pkt_src)
        out_vc = torch.where(tail, -1, out_vc)
        out_is_wl = torch.where(tail, False, out_is_wl)
        out_is_ej = torch.where(tail, False, out_is_ej)

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
        can_new = (st.inj_vc < 0) & (st.q_head < K) & (birth_n <= t) \
            & ihas & ph_ok
        dst_n = take(ss.dests.reshape(G, -1), head)
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
        attempt = torch.where(icl, 0, attempt)
        rcvd = torch.where(icl, 0, rcvd)
        sent = torch.where(icl, 0, sent)
        src_of = torch.where(icl, -1, src_of)
        inj_vc = torch.where(can_new, ivc.to(i8), st.inj_vc)
        inj_pushed = torch.where(can_new, 0, st.inj_pushed)
        q_head = st.q_head + can_new.to(i32)

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
        done = can_push & (inj_pushed >= ss.pkt_len[:, None])
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
            rcvd=rcvd, sent=sent, src_of=src_of,
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
        )

    return step


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def run_cycles(ss: SimStatic, st: SimState, t0: int, t1: int,
               B: int) -> SimState:
    """Step lane-leading ``st`` through cycles ``[t0, t1)``, no freeze.

    The monolithic driver's loop, also used to continue from a carried
    state (``repro_torch.carry``).
    """
    step = make_step(B)
    d = derive(ss, B)
    with torch.no_grad():
        for t in range(t0, t1):
            st = step(ss, d, st, t)
    return st


def _scan_point(ss: SimStatic, st: SimState, cycles: int, B: int) -> SimState:
    """Monolithic driver: every lane steps exactly ``cycles`` cycles.

    Kept as a differential oracle for the chunked driver.
    """
    st = run_cycles(ss, st, 0, cycles, B)
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

    def shape_key(self) -> tuple:
        """Hashable signature of every padded array shape (batch grouping)."""
        return tuple((k, tuple(v.shape)) for k, v in self.ss._asdict().items())


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
    points share one shape (padding is semantically inert).  Tables with
    memory ops, multicast groups or phases, and a ``phy_spec``, raise
    ``NotImplementedError``: those engine paths are not ported yet.
    """
    from repro_torch.phy.rates import pack_link_state
    dev = _device.resolve(device)
    if getattr(tt, "mem_op", None) is not None:
        raise NotImplementedError("closed-loop memory tables: ROADMAP A6")
    if tt.n_mc or tt.n_phases:
        raise NotImplementedError("trace tables (multicast, phases): "
                                  "ROADMAP A5")
    if phy_spec is not None:
        raise NotImplementedError("lossy PHY: ROADMAP A7")
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

    # lossy PHY: inert here (phy_spec is None), kept so the buffer tables
    # go through the same helper as the reference's
    _, _, rx_hold = pack_link_state(
        topo, phy, tt, phy_spec, b_dst, b_depth, b_epb, rx0)

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

    # trace and memory tables: empty/inert for open-loop tables
    P = max(_bucket(0, 8), fl.get("P", 0))
    M = max(_bucket(0, 8), fl.get("M", 0))
    dram = DEFAULT_DRAM
    Y = max(_bucket(topo.n_mem, 4), fl.get("Y", 0))
    stack_sw = np.full(Y, S - 1, np.int32)
    stack_sw[:topo.n_mem] = np.nonzero(topo.is_mem)[0]
    BK = max(_bucket(1, 8), fl.get("BK", 0))
    NK = (N, K)

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
        phases=np.zeros(NK, np.int32), phase_need=np.zeros(P, np.int32),
        n_phases=i32s(0),
        mc_member=np.zeros((M, WMAX), bool),
        mc_dst=np.zeros((M, WMAX), np.int32),
        mc_route=np.zeros(M, np.int32), mc_prim=np.zeros(M, np.int32),
        lens=np.full(NK, phy.pkt_flits, np.int32),
        mem_op=np.zeros(NK, np.int32), mem_ch=np.zeros(NK, np.int32),
        mem_bank=np.zeros(NK, np.int32), mem_row=np.zeros(NK, np.int32),
        reply_row=np.full(NK, -1, np.int32),
        reply_slot=np.full(NK, -1, np.int32),
        req_src=np.full(NK, -1, np.int32),
        req_birth=np.full(NK, NO_PKT, np.int32),
        stack_sw=stack_sw,
        t_row_hit=i32s(dram.t_row_hit), t_row_miss=i32s(dram.t_row_miss),
        max_outst=i32s(2**30),
        wl_serv=np.ones((WMAX, WMAX), np.int32),
        wl_perq=np.zeros((WMAX, WMAX), np.int32),
        rx_hold=np.bool_(rx_hold), max_retx=i32s(1),
        phy_seed=np.uint32(0), ctrl_flits=i32s(phy.ctrl_packet_flits),
        wl_rate0=np.zeros((1, 1), np.int32),
        wl_snr=np.zeros((1, 1), np.float32),
        wl_serv_r=np.ones(1, np.int32),
        wl_perq_r=np.zeros((1, 1, 1), np.int32),
        wl_gp_q=np.zeros((1, 1, 1), np.int32),
        wl_gain_r=np.ones(1, np.float32), wl_gbps_r=np.ones(1, np.float32),
        wl_pkt_bits=np.float32(phy.pkt_flits * phy.flit_bits),
        wl_drift_amp=np.float32(0.0), wl_drift_period=i32s(1),
    )
    ss = SimStatic(**{k: torch.from_numpy(np.asarray(v)).to(dev)
                      for k, v in fields.items()})
    dims = {"B": B, "S": S, "R": R, "K": K, "CS": CS, "CR": CR,
            "M": M, "P": P, "Y": Y, "BK": BK}
    return PackedSim(ss=ss, B=B, n_cores=topo.n_cores, Lw=Lw,
                     n_inj=n_inj, topo=topo, rt=rt, phy=phy, sim=sim,
                     dims=dims)


# --------------------------------------------------------------------------
# batched execution
# --------------------------------------------------------------------------

def _state_dims(ps: PackedSim) -> tuple:
    """(B, N, P, Y) for ``init_state`` from a packed point."""
    return (ps.B, int(ps.ss.births.shape[0]), int(ps.ss.phase_need.shape[0]),
            int(ps.ss.stack_sw.shape[0]))


def run_lanes(ss: SimStatic, st: SimState, B: int, budgets: Sequence[int],
              driver: str = "chunked") -> SimState:
    """Drive lane-leading ``ss``/``st`` to each lane's budget.

    ``budgets`` are the lanes' ``ss.cycles`` on the host.
    ``driver="monolithic"`` runs the fixed-length oracle (one shared
    budget).
    """
    if driver == "monolithic":
        if len(set(budgets)) != 1:
            raise ValueError(
                "monolithic driver needs one shared cycle budget; got "
                f"{sorted(set(budgets))}")
        return _scan_point(ss, st, budgets[0], B)
    if driver != "chunked":
        raise ValueError(f"unknown driver {driver!r}")
    step = make_step(B)
    d = derive(ss, B)
    with torch.no_grad():
        return chunked.run_chunked(
            lambda s, t: step(ss, d, s, t), ss, st, budgets)


def run_batch(pss: Sequence[PackedSim], cycles: int | None = None,
              driver: str = "chunked") -> SimState:
    """Run same-bucket-shape points as lanes of one lockstep batch.

    Returns a ``SimState`` whose leaves carry a leading lane axis, ordered
    as ``pss``.  Cycle budgets and warm-ups are per-lane data and may
    differ; ``cycles`` overrides every lane's budget.  Each lane's result
    equals a solo run of that point, bit for bit.
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
    st = init_state(*_state_dims(pss[0]), lanes=len(pss),
                    device=ss.cycles.device)
    return run_lanes(ss, st, pss[0].B, budgets, driver)


def run(ps: PackedSim, cycles: int | None = None,
        driver: str = "chunked") -> SimState:
    """Single-point API: a batch of one, returned without the lane axis."""
    out = run_batch([ps], cycles=cycles, driver=driver)
    return SimState(*(x[0] for x in out))


def run_from(ss: SimStatic, st: SimState,
             driver: str = "chunked") -> SimState:
    """Run one point from a given (e.g. carried) state, cycle 0 to
    ``ss.cycles``; ``ss``/``st`` and the result have no lane axis."""
    B = int(ss.b_dst.shape[0])
    out = run_lanes(SimStatic(*(x[None] for x in ss)),
                    SimState(*(x[None] for x in st)), B,
                    [int(ss.cycles)], driver)
    return SimState(*(x[0] for x in out))
