"""The scatter/segment formulation of the flit simulator, in PyTorch.
Port of ``repro.core.simulator_ref`` (the JAX reference's original
engine).

It is the port's second, independent formulation of the cycle step, the
oracle the gather engine (``core/simulator.py``) is pinned against
bitwise, and the baseline of ``benchmarks_torch/simspeed.py``.  Where
``simulator.py`` locates every winner through static candidate tables and
gathers, this engine arbitrates with segment minima over flat slot ids
and applies every update as a scatter, as the reference does: output-VC
claims and injection claims scatter into the downstream (buffer, vc);
flits scatter into the arrival pipes; the bank model, reply births,
outstanding credits and the per-pair PHY counters scatter into their
tables; multicast copies find their feeder through the engine-internal
``mc_src`` pointer.  It shares with ``simulator.py`` only what the
reference module shares with its gather engine: the builders, the chunked
driver, ``phy.living``'s window update and ``phy.retx``'s CRC hash.

``SimStatic``, ``SimState``, ``init_state`` and ``pack`` are the
reference module's own (``o_wo`` is an output arbitration slot in
``[0, Wout]``, the stacks are ``stack_of`` per switch, the state carries
``mc_src`` where the gather engine carries ``src_of``).  As in
``simulator.py``, every leaf handed to the step carries a leading lane
dimension G; ``run`` drives one point as a batch of one.

Where the card differs from XLA
-------------------------------
- ``mode="drop"``: JAX discards a scatter update whose index is out of
  range (after wrapping a negative index once); a CUDA scatter with such
  an index fails a device-side assert.  ``_put`` sends those updates to a
  spare slot past the end of the flattened table, which is sliced off.
- ``.at[].set`` with duplicate targets: the winner among duplicates is
  arbitrary on CUDA.  Every ``set`` of the step writes each in-range
  target at most once a cycle (the segment-min arbitration leaves one
  winner per target buffer, output slot, (stack, channel) or WI pair, and
  each source owns its injection buffer), or writes one value to all of
  them (``dead``, the dropped-VC mask); ``tests/test_torch_engine_
  equivalence.py`` asserts it on every program.
- ``jax.ops.segment_min`` is ``scatter_reduce_(..., "amin")`` seeded with
  the dtype's maximum, JAX's value for an empty segment; ``.at[].min`` is
  the same reduction over the table itself.
- The float32 scatter-adds into ``mem_q_sum`` and ``mem_svc_sum`` are
  atomics on CUDA, in no fixed order.  Every addend is integer-valued, so
  the result does not depend on the order while every partial sum stays
  below 2^24 (checked at fig8's sizes by the tests).
"""
from __future__ import annotations

import dataclasses
import math
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
RXWMAX = 4       # max concurrent rx streams per WI
EJ_WAYS = 4      # parallel ejection channels at memory-stack switches

i8, i16, i32, f32 = torch.int8, torch.int16, torch.int32, torch.float32


def _bucket(n: int, q: int) -> int:
    return int(np.ceil(max(n, 1) / q) * q)


class SimStatic(NamedTuple):
    """Padded, device-resident topology/routing/traffic description;
    fields, shapes and dtypes of ``repro.core.simulator_ref.SimStatic``
    (``phy_seed`` held in int64)."""

    # buffers
    b_dst: torch.Tensor        # [B] dst switch (dummy rows -> S_pad-1)
    b_serv: torch.Tensor       # [B] cycles between flits INTO this buffer
    b_lat: torch.Tensor        # [B] forward -> arrival latency (>=1)
    b_epb: torch.Tensor        # [B] pJ/bit of the link feeding this buffer
    b_depth: torch.Tensor      # [B] buffer depth in flits
    b_wi: torch.Tensor         # [B] WI id at the buffer's switch (-1 none)
    b_is_rx: torch.Tensor      # [B] bool: wireless rx buffer
    b_ej_ways: torch.Tensor    # [B] parallel ejection channels at dst switch
    s_pad: torch.Tensor        # scalar: padded switch count (eject stride)
    # routing
    next_out: torch.Tensor     # [S, S] routing output id
    o_buf: torch.Tensor        # [R] target buffer id (dummy B for eject/pad)
    o_wo: torch.Tensor         # [R] output arbitration slot (Wout = drop)
    o_is_wl: torch.Tensor      # [R] bool wireless pair link
    o_is_ej: torch.Tensor      # [R] bool ejection
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
    # trace tables (phase barriers + multicast groups)
    phases: torch.Tensor       # [N, K]
    phase_need: torch.Tensor   # [P]
    n_phases: torch.Tensor     # scalar int32 (0 = open-loop)
    mc_member: torch.Tensor    # [M, WMAX] bool
    mc_dst: torch.Tensor       # [M, WMAX]
    mc_route: torch.Tensor     # [M]
    mc_prim: torch.Tensor      # [M]
    # memory tables (closed-loop request/reply)
    lens: torch.Tensor         # [N, K] per-slot packet length in flits
    mem_op: torch.Tensor       # [N, K] MEM_* op code (0 = none)
    mem_ch: torch.Tensor       # [N, K]
    mem_bank: torch.Tensor     # [N, K]
    mem_row: torch.Tensor      # [N, K]
    reply_row: torch.Tensor    # [N, K]
    reply_slot: torch.Tensor   # [N, K]
    req_src: torch.Tensor      # [N, K]
    req_birth: torch.Tensor    # [N, K]
    stack_of: torch.Tensor     # [S] stack index of a switch (-1 = none)
    t_row_hit: torch.Tensor    # scalar i32
    t_row_miss: torch.Tensor   # scalar i32
    max_outst: torch.Tensor    # scalar i32
    # lossy PHY tables (multicast: group service/PER = max over members)
    wl_serv: torch.Tensor      # [WMAX, WMAX]
    wl_perq: torch.Tensor      # [WMAX, WMAX]
    rx_hold: torch.Tensor      # bool
    max_retx: torch.Tensor     # scalar i32
    phy_seed: torch.Tensor     # scalar int64 holding the u32 CRC hash seed
    ctrl_flits: torch.Tensor   # scalar i32
    # living-channel tables (placeholder shapes unless drift/re-selection)
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
    """Per-cycle state; leaves of ``repro.core.simulator_ref.SimState``,
    in its order.  Every leaf but ``mc_src`` (this engine's multicast
    feeder pointer) has the gather engine's name, shape and dtype."""

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
    mc_id: torch.Tensor        # [B, V] multicast group id (-1 = unicast)
    mc_src: torch.Tensor       # [B, V] flat sender slot feeding this
    #                            multicast copy (-1)
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
    rdy: torch.Tensor          # [N, K]
    dead: torch.Tensor         # [N, K] bool: tombstoned reply slots
    outst: torch.Tensor        # [N]
    bank_busy: torch.Tensor    # [Y, CH, BK]
    bank_row: torch.Tensor     # [Y, CH, BK]
    outst_peak: torch.Tensor   # [N]
    amat_sum: torch.Tensor     # f32
    amat_pkts: torch.Tensor
    mem_reads: torch.Tensor    # [Y]
    mem_writes: torch.Tensor   # [Y]
    mem_row_hits: torch.Tensor  # [Y]
    mem_q_sum: torch.Tensor    # [Y] f32
    mem_svc_sum: torch.Tensor  # [Y] f32
    mem_flits: torch.Tensor    # [Y]
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
    wl_pair_flits: torch.Tensor  # [WMAX, WMAX]
    wl_fail_flits: torch.Tensor  # [WMAX, WMAX]
    wl_pkts: torch.Tensor
    wl_nacks: torch.Tensor
    pkts_dropped: torch.Tensor
    wl_drop_flits: torch.Tensor
    mem_drop_reads: torch.Tensor
    # living-channel dynamics (placeholder shapes unless living)
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
    """Zero state, leaf for leaf the reference's ``init_state`` (the
    same placeholder shapes of disabled paths as ``simulator.init_state``);
    ``lanes`` prepends a lane dimension to every leaf."""
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
        mc_id=full(BV, -1, i32), mc_src=full(BV, -1, i32),
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
# lane-leading gathers and scatters with jnp's index rules
# --------------------------------------------------------------------------

def _at(a: torch.Tensor, *idx, inb: bool = False) -> torch.Tensor:
    """``a[g, idx0, idx1, ...]`` per lane: ``a`` is [G, D0, D1, ..., *rest],
    each index lane-leading (broadcast together); the result has the
    broadcast index shape followed by ``rest``.  jnp's gather rule: a
    negative index wraps once, the rest clamps into range (``inb``: the
    caller clipped already)."""
    G, k = a.shape[0], len(idx)
    dims, rest = a.shape[1:1 + k], a.shape[1 + k:]
    idx = torch.broadcast_tensors(*idx)
    flat = None
    for n, i in zip(dims, idx):
        i = i.long()
        if not inb:
            i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
        flat = i if flat is None else flat * n + i
    shape = flat.shape
    fl = flat.reshape(G, -1)
    nrest = math.prod(rest)
    src = a.reshape(G, -1, nrest)
    out = torch.gather(src, 1, fl[..., None].expand(G, fl.shape[1], nrest))
    return out.reshape(tuple(shape) + tuple(rest))


def _index(dims: Sequence[int], idx) -> torch.Tensor:
    """Flat per-lane scatter targets into a table of trailing shape
    ``dims`` (the broadcast index shape), with jnp's ``mode="drop"`` rule:
    a negative index wraps once, and an update with any index still out of
    range goes to the spare slot ``prod(dims)``."""
    idx = torch.broadcast_tensors(*idx)
    flat, ok = None, None
    for n, i in zip(dims, idx):
        i = i.long()
        i = torch.where(i < 0, i + n, i)
        v = (i >= 0) & (i < n)
        flat = i if flat is None else flat * n + i
        ok = v if ok is None else ok & v
    return torch.where(ok, flat, math.prod(dims))


def _put(a: torch.Tensor, ix: torch.Tensor, val, how: str) -> torch.Tensor:
    """``a.at[idx].set/add/min(val, mode="drop")`` per lane, ``ix`` from
    ``_index`` and ``val`` broadcast to its shape: the table is flattened
    with one spare slot appended, which takes the dropped updates and is
    sliced off.  Small-integer adds run in int32 (the step's int8 pipe
    counts never wrap)."""
    G = a.shape[0]
    dt = i32 if how == "add" and a.dtype in (i8, i16) else a.dtype
    flat = a.reshape(G, -1).to(dt)
    buf = torch.cat([flat, flat[:, :1]], 1)
    val = torch.as_tensor(val, dtype=dt, device=a.device)
    val = torch.broadcast_to(val, ix.shape).reshape(G, -1)
    ixf = ix.reshape(G, -1)
    if how == "set":
        buf.scatter_(1, ixf, val)
    elif how == "add":
        buf.scatter_add_(1, ixf, val)
    elif how == "min":
        buf.scatter_reduce_(1, ixf, val, "amin", include_self=True)
    else:
        raise ValueError(how)
    return buf[:, :-1].to(a.dtype).reshape(a.shape)


def _segment_min(data: torch.Tensor, ids: torch.Tensor,
                 num: int) -> torch.Tensor:
    """``jax.ops.segment_min`` per lane: [G, num] minima of ``data`` over
    each segment id in ``[0, num)``; an empty segment holds the dtype's
    maximum and ids out of range are dropped (a spare segment)."""
    G = data.shape[0]
    ix = torch.where((ids >= 0) & (ids < num), ids, num).reshape(G, -1)
    out = torch.full((G, num + 1), torch.iinfo(data.dtype).max,
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(1, ix.long(), data.reshape(G, -1), "amin",
                        include_self=True)
    return out[:, :num]


def _argmax_bool(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool mask over the last axis: the first True
    (0 when none), int32."""
    n = mask.shape[-1]
    ar = torch.arange(n, dtype=i32, device=mask.device)
    first = torch.where(mask, ar, n).amin(-1)
    return torch.where(first < n, first, 0)


def _argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.argmin``: the first index of the minimum along ``dim``."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    ar = torch.arange(n, dtype=i32, device=x.device).view(shape)
    return torch.where(x == x.amin(dim, keepdim=True), ar, n).amin(dim)


def _sum(x: torch.Tensor, dims=(1, 2)) -> torch.Tensor:
    """Per-lane int32 sum (JAX sums bools and int32 in int32)."""
    return x.sum(dims, dtype=i32)


def _route_fields(ss: SimStatic, at_switch, dst):
    """Gather the routing decision for packets at `at_switch` going to `dst`."""
    oo = _at(ss.next_out, at_switch, dst)
    return (oo, _at(ss.o_buf, oo), _at(ss.o_wo, oo), _at(ss.o_is_wl, oo),
            _at(ss.o_is_ej, oo))


def make_step(B: int, Wout: int, RXW: int = 1, mem_on: bool = False,
              phy_on: bool = False, drift_on: bool = False,
              reselect: bool = False):
    """Build the per-cycle transition ``step(ss, st, t) -> st`` (shapes
    baked in), the reference's ``make_step`` over lane-leading ``ss`` and
    ``st``; ``t`` is the cycle, a Python int shared by the lanes.

    ``mem_on`` (static) adds the closed-loop memory path in scatter style,
    ``phy_on`` the lossy-channel ARQ path; with both off the program is
    the ideal open-loop step.  ``drift_on``/``reselect`` (static, imply
    ``phy_on``) add the living channel: ``phy.living.make_window_fn``
    refreshes the per-pair link tables at every window boundary.
    """
    living = drift_on or reselect
    assert not living or phy_on, "living channel requires the ARQ path"
    NC = B * V
    BIG = 4 * NC
    BIGS = 1 << 30
    consts: dict = {}

    def const(dev, N: int, P: int):
        key = (dev, N, P)
        if key not in consts:
            consts[key] = dict(
                flat2d=torch.arange(NC, dtype=i32, device=dev).reshape(B, V),
                b_ids=torch.arange(B, dtype=i32, device=dev),
                warr=torch.arange(WMAX, dtype=i32, device=dev),
                vcol=torch.arange(V, dtype=i32, device=dev),
                rarr=torch.arange(RXWMAX, dtype=i32, device=dev),
                d_ar=torch.arange(DMAX, dtype=i32, device=dev),
                n_ar=torch.arange(N, dtype=i32, device=dev),
                parr=torch.arange(P, dtype=i32, device=dev))
        return consts[key]

    def step(ss: SimStatic, st: SimState, t: int) -> SimState:
        G = st.pkt_src.shape[0]
        dev = st.pkt_src.device
        S = ss.next_out.shape[1]
        M = ss.mc_member.shape[1]
        P = ss.phase_need.shape[1]
        Nn, Kk = ss.phases.shape[1], ss.phases.shape[2]
        c = const(dev, Nn, P)
        flat2d, b_ids, warr, vcol0 = c["flat2d"], c["b_ids"], c["warr"], \
            c["vcol"]

        def L(x, nd=3):            # [G] per-lane scalar -> broadcastable
            return x.view((G,) + (1,) * (nd - 1))

        if living and t % CHUNK_CYCLES == 0:
            # living channel: refresh the dynamic per-pair link tables at
            # every scan-window boundary (the chunked driver replays the
            # ones a drained lane skips)
            st = make_window_fn(ss, drift_on, reselect)(st, t)
        post = (ss.warmup <= t).to(i32)                          # [G]
        rot = t % NC
        rx_ids = (ss.rx0[:, None] + warr).clamp(0, B - 1)         # [G,W]
        rx_slot = (b_ids - ss.rx0[:, None]).clamp(0, WMAX - 1)    # [G,B]

        # ---- 1. arrivals -------------------------------------------------
        arrive = st.pipe[..., 0]
        rcvd = st.rcvd + arrive
        pipe = torch.cat([st.pipe[..., 1:], torch.zeros_like(
            st.pipe[..., :1])], dim=-1)
        active = st.pkt_src >= 0
        occ = torch.where(active, rcvd - st.sent, 0)

        # ---- 2a. output-VC claims ---------------------------------------
        # one new downstream-VC allocation per target buffer per cycle;
        # pre-wireless packets claim VCs [0, V/2), post [V/2, V); rx
        # buffers admit any VC
        free_mask = st.pkt_src < 0                                # [G,B,V]
        ob_c0 = st.out_buf.clamp(0, B - 1)
        classA = vcol0 < V // 2                                   # [V]
        tgt_rx = _at(ss.b_is_rx, ob_c0, inb=True)                 # [G,B,V]
        allowed = torch.where(tgt_rx[..., None], True, torch.where(
            st.phase2[..., None], ~classA, classA))               # [G,B,V,V]
        free_ok = _at(free_mask, ob_c0, inb=True) & allowed
        has_free_c = free_ok.any(-1)
        first_free_c = _argmax_bool(free_ok)                      # [G,B,V]
        # multicast senders: all-or-nothing claim at every member rx buffer
        is_mc = (st.mc_id >= 0) & st.out_is_wl & ~st.phase2 & active
        mcid_c = st.mc_id.clamp(0, M - 1)
        member = _at(ss.mc_member, mcid_c, inb=True)              # [G,B,V,W]
        free_any_rx = _at(free_mask, rx_ids, inb=True).any(-1)    # [G,W]
        free_all_mc = torch.where(member, free_any_rx[:, None, None],
                                  True).all(-1)                   # [G,B,V]
        # store-and-forward receivers (rx_hold): rx slots claim their
        # downstream VC only with the whole packet in
        if mem_on:
            plen0 = _at(ss.lens, st.pkt_src.clamp(0, Nn - 1),
                        st.pkt_idx.clamp(0, Kk - 1), inb=True)
        else:
            plen0 = L(ss.pkt_len)
        hold0_ok = ~(L(ss.rx_hold) & ss.b_is_rx[..., None]) | (rcvd >= plen0)
        need_base = active & (st.out_vc < 0) & ~st.out_is_ej & (occ > 0) \
            & (st.out_buf < B) & hold0_ok
        need_uni = need_base & ~is_mc & has_free_c
        need_mc = need_base & is_mc & free_all_mc
        score_all = (flat2d - rot) % NC                           # [B,V]
        tb = torch.where(need_uni, st.out_buf, B)
        score = torch.where(need_uni, score_all, BIG)             # [G,B,V]
        segmin = _segment_min(score, tb, B + 1)                   # [G,B+1]
        # multicast contenders: masked min per member receiver, combined
        # with the unicast segment minima into the per-rx-buffer winner
        score_mc = torch.where(need_mc, score_all, BIG)
        mc_min = torch.where(member & need_mc[..., None],
                             score_mc[..., None], BIG).amin((1, 2))  # [G,W]
        win_code_rx = torch.minimum(_at(segmin, rx_ids, inb=True), mc_min)
        comb_b = torch.where(ss.b_is_rx, _at(win_code_rx, rx_slot, inb=True),
                             segmin[:, :B])                       # [G,B]
        win = need_uni & (score == _at(comb_b, ob_c0, inb=True)) \
            & (score < BIG)
        win_all_mc = torch.where(
            member, win_code_rx[:, None, None] == score_mc[..., None],
            True).all(-1)                                         # [G,B,V]
        win_mc = need_mc & win_all_mc

        # scatter the claim into the downstream (b_t, v_t); a loser's
        # target is B, out of range: dropped
        b_t = torch.where(win, st.out_buf, B)
        v_t = first_free_c
        nb = _at(ss.b_dst, ob_c0, inb=True)
        d_oo, d_ob, d_owo, d_owl, d_oej = _route_fields(ss, nb, st.pkt_dst)
        ix_claim = _index((B, V), (b_t, v_t))

        def claim(arr, val):
            return _put(arr, ix_claim, val, "set")

        pkt_src = claim(st.pkt_src, st.pkt_src)
        pkt_idx = claim(st.pkt_idx, st.pkt_idx)
        pkt_dst = claim(st.pkt_dst, st.pkt_dst)
        born = claim(st.born, st.born)
        out_o = claim(st.out_o, d_oo.to(i32))
        out_buf = claim(st.out_buf, d_ob.to(i32))
        out_wo = claim(st.out_wo, d_owo.to(i32))
        out_is_wl = claim(st.out_is_wl, d_owl)
        out_is_ej = claim(st.out_is_ej, d_oej)
        out_vc = claim(st.out_vc, -1)
        phase2 = claim(st.phase2, st.phase2 | tgt_rx)
        mc_id = claim(st.mc_id, st.mc_id)
        mc_src = claim(st.mc_src, -1)
        attempt = claim(st.attempt, 0)
        rcvd = claim(rcvd, 0)
        sent = claim(st.sent, 0)
        # upstream learns its allocated VC
        out_vc = torch.where(win, v_t.to(out_vc.dtype), out_vc)

        # multicast copy install: receiver-side, one copy per member rx
        # buffer of the full-group winner, each addressed to its per-WI
        # destination from the group table
        mcs = torch.where(member & need_mc[..., None], score_mc[..., None],
                          BIG)                                    # [G,B,V,W]
        mc_src_w = _argmin(mcs.reshape(G, NC, WMAX), 1)           # [G,W]
        grp_ok_w = _at(win_all_mc.reshape(G, NC), mc_src_w, inb=True)
        inst_w = (mc_min < BIG) & (mc_min < _at(segmin, rx_ids, inb=True)) \
            & grp_ok_w
        vfree_w = _argmax_bool(_at(free_mask, rx_ids, inb=True))  # [G,W]
        inst_b = ss.b_is_rx & _at(inst_w, rx_slot, inb=True)      # [G,B]
        icl_mc = inst_b[..., None] \
            & (_at(vfree_w, rx_slot, inb=True)[..., None] == vcol0)
        sw_b = _at(mc_src_w, rx_slot, inb=True)                   # [G,B]

        def gmc(a):
            return _at(a.reshape(G, NC), sw_b, inb=True)          # [G,B]

        copy_dst = _at(ss.mc_dst, gmc(st.mc_id).clamp(0, M - 1), rx_slot,
                       inb=True).clamp(0, S - 1)
        c_oo, c_ob, c_owo, c_owl, c_oej = _route_fields(ss, ss.b_dst,
                                                        copy_dst)

        def mupd(old, val_b):
            return torch.where(icl_mc, val_b[..., None], old)

        pkt_src = mupd(pkt_src, gmc(st.pkt_src))
        pkt_idx = mupd(pkt_idx, gmc(st.pkt_idx))
        pkt_dst = mupd(pkt_dst, copy_dst)
        born = mupd(born, gmc(st.born))
        out_o = mupd(out_o, c_oo.to(i32))
        out_buf = mupd(out_buf, c_ob.to(i32))
        out_wo = mupd(out_wo, c_owo.to(i32))
        out_is_wl = mupd(out_is_wl, c_owl)
        out_is_ej = mupd(out_is_ej, c_oej)
        out_vc = torch.where(icl_mc, -1, out_vc)
        phase2 = torch.where(icl_mc, True, phase2)
        mc_id = mupd(mc_id, gmc(st.mc_id))
        mc_src = mupd(mc_src, sw_b)
        attempt = torch.where(icl_mc, 0, attempt)
        rcvd = torch.where(icl_mc, 0, rcvd)
        sent = torch.where(icl_mc, 0, sent)
        # multicast sender: "granted" sentinel (delivery is receiver-side)
        out_vc = torch.where(win_mc, 0, out_vc)

        active = pkt_src >= 0
        occ = torch.where(active, rcvd - sent, 0)

        # per-slot packet attributes from the [N, K] tables: lengths,
        # memory op codes, the ejection-way override
        psrc_c = pkt_src.clamp(0, Nn - 1)
        pidx_c = pkt_idx.clamp(0, Kk - 1)
        way_bv = vcol0 % ss.b_ej_ways[..., None]                  # [G,B,V]
        if mem_on:
            plen_bv = _at(ss.lens, psrc_c, pidx_c, inb=True)
            op_bv = torch.where(active, _at(ss.mem_op, psrc_c, pidx_c,
                                            inb=True), 0)
            memrq_bv = (op_bv == 1) | (op_bv == 2)
            ch_bv = _at(ss.mem_ch, psrc_c, pidx_c, inb=True).clamp(
                0, MEM_CH - 1)
            way_bv = torch.where(memrq_bv & out_is_ej,
                                 ch_bv % ss.b_ej_ways[..., None], way_bv)
        else:
            plen_bv = L(ss.pkt_len)

        # ---- 2b. forwarding: wired links, ejection, wireless -------------
        inflight = pipe.sum(-1, dtype=i32)                        # [G,B,V]
        ob_c = out_buf.clamp(0, B - 1)
        ovc_c = out_vc.clamp(0, V - 1)
        occ_down = _at(rcvd, ob_c, ovc_c, inb=True) \
            - _at(sent, ob_c, ovc_c, inb=True)
        space = _at(ss.b_depth, ob_c, inb=True) - occ_down \
            - _at(inflight, ob_c, ovc_c, inb=True)
        link_free = _at(st.busy_until, ob_c, inb=True) <= t
        # multicast sender: backpressure is the MIN over its member copies
        # (located through the mc_src pointer on the rx region)
        is_mc2 = (mc_id >= 0) & out_is_wl & ~phase2 & active      # [G,B,V]
        mcid_c2 = mc_id.clamp(0, M - 1)
        member2 = _at(ss.mc_member, mcid_c2, inb=True)            # [G,B,V,W]
        mcs_rx = _at(mc_src, rx_ids, inb=True)                    # [G,W,V]
        room_rx = _at(ss.b_depth, rx_ids, inb=True)[..., None] \
            - _at(occ, rx_ids, inb=True) - _at(inflight, rx_ids, inb=True)
        cp = mcs_rx[:, None, None] == flat2d[:, :, None, None]    # [G,B,V,W,V]
        cp_space = torch.where(cp, room_rx[:, None, None], BIGS).amin(-1)
        cp_space = torch.where(cp.any(-1), cp_space, 0)           # [G,B,V,W]
        space_mc = torch.where(member2, cp_space, BIGS).amin(-1)
        space = torch.where(is_mc2, space_mc, space)
        busy_rx_ok = _at(st.busy_until, rx_ids, inb=True) <= t    # [G,W]
        lf_mc = torch.where(member2, busy_rx_ok[:, None, None], True).all(-1)
        link_free = torch.where(is_mc2, lf_mc, link_free)
        # token MAC: wireless transmission only once the whole packet is here
        whole = rcvd >= plen_bv
        wl_ok = ~out_is_wl | ~L(ss.mac_token) | whole
        # single-channel mode: nothing flies while the channel is busy
        wl_ch_free = ~ss.wl_single | (st.wl_busy_until <= t)      # [G]
        wl_ok &= ~out_is_wl | L(wl_ch_free)
        # crossbar medium: receivers are not serialized
        link_free |= out_is_wl & ~L(ss.wl_rx_busy)
        # store-and-forward receivers: rx slots forward only whole packets
        hold_ok = ~(L(ss.rx_hold) & ss.b_is_rx[..., None]) | whole
        if phy_on:
            # lossy PHY: ARQ senders hold the whole packet, pairs pace at
            # the link rate, the CRC outcome is the (seed, packet,
            # attempt) hash; living points read the per-window tables
            serv_tab = st.wl_serv_d if living else ss.wl_serv     # [G,W,W]
            perq_tab = st.wl_perq_d if living else ss.wl_perq
            ws_b = ss.b_wi.clamp(0, WMAX - 1)                     # [G,B]
            ws_bv = ws_b[..., None]                               # [G,B,1]
            wd_bv = (out_buf - L(ss.rx0)).clamp(0, WMAX - 1)      # [G,B,V]
            serv_wl_bv = _at(serv_tab, ws_bv, wd_bv, inb=True)
            perq_bv = _at(perq_tab, ws_bv, wd_bv, inb=True)
            # broadcast ARQ: a multicast attempt is paced and CRC-checked
            # against its WORST member link (the hash is link-independent,
            # so the member outcomes are comonotone)
            serv_mcg = torch.where(member2, _at(serv_tab, ws_b, inb=True)[
                :, :, None], 0).amax(-1)                          # [G,B,V]
            perq_mcg = torch.where(member2, _at(perq_tab, ws_b, inb=True)[
                :, :, None], 0).amax(-1)
            serv_wl_bv = torch.where(is_mc2, serv_mcg, serv_wl_bv)
            perq_bv = torch.where(is_mc2, perq_mcg, perq_bv)
            pb_ok = _at(st.pair_busy, ws_bv, wd_bv, inb=True) <= t
            wl_ok &= ~out_is_wl | (whole & pb_ok)
            uid = psrc_c * 65536 + pidx_c
            fail_bv = crc_fail(L(ss.phy_seed), uid, attempt, perq_bv)
        elig = active & (occ > 0) & wl_ok & hold_ok \
            & (out_is_ej | ((out_vc >= 0) & (space > 0) & link_free))
        # multi-channel ejection: memory stacks sink `b_ej_ways` flits a
        # cycle, cores one; the way is vc % ways (memory requests: their
        # pseudo-channel)
        wo_base = torch.where(out_is_ej, out_wo + way_bv * L(ss.s_pad),
                              out_wo)
        wo = torch.where(elig & ~is_mc2, wo_base, Wout)
        score2 = torch.where(elig, score_all, BIG)
        segmin2 = _segment_min(score2, wo, Wout + 1)              # [G,Wout+1]
        # multicast air winners: masked min per (sub-channel, receiver),
        # combined with the unicast slot minima; a multicast flies only if
        # it wins at EVERY member receiver
        r_bc = (ss.b_wi % RXW).clamp(0, RXWMAX - 1)[..., None].expand(
            G, B, V)                                              # [G,B,V]
        mc_sc = torch.where(is_mc2 & elig, score_all, BIG)
        mask4 = member2[:, None] & (r_bc[:, None, :, :, None]
                                    == c["rarr"][:, None, None, None])
        mc_min2 = torch.where(mask4, mc_sc[:, None, :, :, None],
                              BIG).amin((2, 3))                   # [G,RX,W]
        # every wireless sender's receiver slot id, reconstructed from its
        # own out_wo (slot = base + dst_wi*RXW + r): anchor = out_buf - rx0
        anchor = (out_buf - L(ss.rx0)).clamp(0, WMAX - 1)         # [G,B,V]
        slot_w = out_wo[..., None] + (warr - anchor[..., None]) * RXW
        comb_w = torch.minimum(
            _at(segmin2, slot_w.clamp(0, Wout), inb=True),
            _at(mc_min2, r_bc[..., None], warr.view(1, 1, 1, WMAX),
                inb=True))                                        # [G,B,V,W]
        wl_all2 = torch.where(member2, comb_w == score_all[..., None],
                              True).all(-1)
        mc_at_mine = _at(mc_min2, r_bc, anchor, inb=True)         # [G,B,V]
        fwd_uni = elig & ~is_mc2 \
            & (score2 == _at(segmin2, wo.clamp(0, Wout), inb=True)) \
            & (score2 < BIG) & (~out_is_wl | (score2 < mc_at_mine))
        fwd = fwd_uni | (elig & is_mc2 & wl_all2)

        # wireless sender-side cap: one flit per transmitting WI per cycle
        # (one WI total in single-channel mode); no-op for the crossbar
        is_wl_fwd = fwd & out_is_wl
        capped = is_wl_fwd & L(ss.wl_sender_cap)
        snd = torch.where(capped, torch.where(
            L(ss.wl_single), 0, ss.b_wi[..., None]), WMAX)
        segmin3 = _segment_min(score2, snd, WMAX + 1)
        keep = ~capped | (score2 == _at(segmin3, snd.clamp(0, WMAX),
                                        inb=True))
        fwd &= keep
        is_wl_fwd = fwd & out_is_wl

        sent = sent + fwd.to(i32)
        wl_nacks, wl_pkts = st.wl_nacks, st.wl_pkts
        pkts_dropped, wl_drop_flits = st.pkts_dropped, st.wl_drop_flits
        if phy_on:
            # CRC on the tail of every air attempt: NACK rewinds the
            # sender, the bounded-ARQ loser is dropped
            first_wl_phy = is_wl_fwd & (sent == 1)   # pre-rewind header
            raw_tail = fwd & (sent >= plen_bv)
            fail_tail = raw_tail & out_is_wl & fail_bv
            retx_m = fail_tail & (attempt + 1 < L(ss.max_retx))
            drop = fail_tail & ~retx_m
            tail = raw_tail & ~fail_tail
            sent = torch.where(retx_m, sent - plen_bv, sent)
            attempt = torch.where(retx_m, attempt + 1, attempt)
            wl_nacks = wl_nacks + post * _sum(fail_tail)
            wl_pkts = wl_pkts + post * _sum(tail & out_is_wl)
            pkts_dropped = pkts_dropped + post * _sum(drop)
            # a drop's ejection(s) never happen: count the lost payload
            # (once per member copy for multicast, as wl_rx_flits)
            member_cnt = torch.where(is_mc2, member2.sum(-1, dtype=i32), 1)
            wl_drop_flits = wl_drop_flits + post * _sum(
                torch.where(drop, plen_bv * member_cnt, 0))
        else:
            tail = fwd & (sent >= plen_bv)
        ej = fwd & out_is_ej
        nej = fwd & ~out_is_ej

        # ejection stats
        n_ej = _sum(ej)
        flits_del = st.flits_del + post * n_ej
        tail_ej = tail & out_is_ej
        lat_ok = tail_ej & (born >= L(ss.warmup))
        pkts_del = st.pkts_del + post * _sum(tail_ej)
        lat_sum = st.lat_sum + post * torch.where(
            lat_ok, (t - born + 1).to(f32), 0.0).sum((1, 2))
        lat_pkts = st.lat_pkts + post * _sum(lat_ok)

        # ---- phase barrier bookkeeping (trace tables; raw counts)
        phv = _at(ss.phases, psrc_c, pidx_c, inb=True)            # [G,B,V]
        cur = st.cur_phase
        phase_del = st.phase_del + _sum(tail_ej & (phv == L(cur)))
        if phy_on:
            # an ARQ drop's ejections (one per member copy) never happen:
            # credit them to the open phase so a lossy trace drains
            phase_del = phase_del + _sum(torch.where(
                drop & (phv == L(cur)), member_cnt, 0))
        at_cur = c["parr"] == cur[:, None]                        # [G,P]
        phase_flits = st.phase_flits + torch.where(at_cur, n_ej[:, None], 0)
        in_trace = (ss.n_phases > 0) & (cur < ss.n_phases)
        needed = _at(ss.phase_need, cur.clamp(0, P - 1), inb=True)
        complete = in_trace & (phase_del >= needed)
        phase_end = torch.where(at_cur & complete[:, None], t + 1,
                                st.phase_end)
        cur_phase = cur + complete.to(i32)
        phase_del = torch.where(complete, 0, phase_del)

        # ---- closed-loop memory: bank model + reply gating, scatter style
        rdy, outst, dead = st.rdy, st.outst, st.dead
        bank_busy, bank_row = st.bank_busy, st.bank_row
        amat_sum, amat_pkts = st.amat_sum, st.amat_pkts
        mem_reads, mem_writes = st.mem_reads, st.mem_writes
        mem_row_hits = st.mem_row_hits
        mem_q_sum, mem_svc_sum = st.mem_q_sum, st.mem_svc_sum
        mem_flits = st.mem_flits
        if mem_on:
            Yp, BKp = bank_busy.shape[1], bank_busy.shape[3]
            # (a) request arrivals: every tail-ejected read/write enters
            # its (stack, channel, bank); way arbitration admits at most
            # one per (stack, channel) per cycle, so the sets are unique
            y_b = _at(ss.stack_of, ss.b_dst.clamp(0, S - 1), inb=True)
            y_bv = y_b[..., None].expand(G, B, V)
            is_rq = tail_ej & memrq_bv & (y_bv >= 0)              # [G,B,V]
            yc = y_bv.clamp(0, Yp - 1)
            bank_bv = _at(ss.mem_bank, psrc_c, pidx_c, inb=True).clamp(
                0, BKp - 1)
            row_bv = _at(ss.mem_row, psrc_c, pidx_c, inb=True)
            bb = _at(bank_busy, yc, ch_bv, bank_bv, inb=True)
            br = _at(bank_row, yc, ch_bv, bank_bv, inb=True)
            hit = is_rq & (br == row_bv)
            svc = torch.where(hit, L(ss.t_row_hit), L(ss.t_row_miss))
            start = bb.clamp(min=t + 1)
            done = start + svc                                    # [G,B,V]
            ty = torch.where(is_rq, yc, Yp)
            ix_bank = _index((Yp, MEM_CH, BKp), (ty, ch_bv, bank_bv))
            bank_busy = _put(bank_busy, ix_bank, done, "set")
            bank_row = _put(bank_row, ix_bank, row_bv, "set")
            # reply birth into the paired slot's rdy
            rrow_c = _at(ss.reply_row, psrc_c, pidx_c, inb=True).clamp(
                0, Nn - 1)
            rslot_c = _at(ss.reply_slot, psrc_c, pidx_c, inb=True).clamp(
                0, Kk - 1)
            trow = torch.where(is_rq, rrow_c, Nn)
            rdy = _put(rdy, _index((Nn, Kk), (trow, rslot_c)), done, "min")
            # per-stack service stats
            rd_m = is_rq & (op_bv == 1)
            wr_m = is_rq & (op_bv == 2)
            postb = L(post)
            postf = postb.to(f32)
            mem_reads = _put(mem_reads, _index(
                (Yp,), (torch.where(rd_m, yc, Yp),)), postb, "add")
            mem_writes = _put(mem_writes, _index(
                (Yp,), (torch.where(wr_m, yc, Yp),)), postb, "add")
            mem_row_hits = _put(mem_row_hits, _index(
                (Yp,), (torch.where(hit, yc, Yp),)), postb, "add")
            ix_ty = _index((Yp,), (ty,))
            mem_q_sum = _put(mem_q_sum, ix_ty,
                             postf * (start - (t + 1)).to(f32), "add")
            mem_svc_sum = _put(mem_svc_sum, ix_ty, postf * svc.to(f32),
                               "add")
            data_bv = torch.where(rd_m, _at(ss.lens, rrow_c, rslot_c,
                                            inb=True),
                                  torch.where(wr_m, plen_bv, 0))
            mem_flits = _put(mem_flits, ix_ty, postb * data_bv, "add")
            # (b) reply/ack completion at the requester: AMAT + credit
            is_rep = tail_ej & ((op_bv == 3) | (op_bv == 4))
            rb = _at(ss.req_birth, psrc_c, pidx_c, inb=True)
            amat_ok = is_rep & (op_bv == 3) & (rb >= L(ss.warmup))
            amat_sum = amat_sum + post * torch.where(
                amat_ok, (t - rb + 1).to(f32), 0.0).sum((1, 2))
            amat_pkts = amat_pkts + post * _sum(amat_ok)
            rq_t = torch.where(is_rep, _at(ss.req_src, psrc_c, pidx_c,
                                           inb=True), Nn)
            outst = _put(outst, _index((Nn,), (rq_t,)), -1, "add")

        # non-eject: schedule arrival downstream, occupy link / rx / channel
        if phy_on:
            first_wl = first_wl_phy
            ctrl_bv = (L(ss.ctrl_flits) * serv_wl_bv).clamp(min=1)
            lat_wl_bv = L(ss.lat_wl - ss.serv_wl) + serv_wl_bv
            # failing attempts occupy the channel but deliver nothing
            nej_del = nej & ~(out_is_wl & fail_bv)
        else:
            first_wl = is_wl_fwd & (sent == 1)   # header => control packet
            ctrl_bv = L(ss.ctrl_cycles)
            lat_wl_bv = L(ss.lat_wl)
            serv_wl_bv = L(ss.serv_wl)
            nej_del = nej
        lat_t = torch.where(out_is_wl, lat_wl_bv, _at(ss.b_lat, ob_c,
                                                      inb=True)) \
            + torch.where(first_wl & ~L(ss.wl_rx_busy), ctrl_bv, 0)
        serv_t = torch.where(out_is_wl, serv_wl_bv, _at(ss.b_serv, ob_c,
                                                        inb=True)) \
            + torch.where(first_wl, ctrl_bv, 0)
        nb_t = torch.where(nej_del & ~is_mc2, out_buf, B)
        nd_t = (lat_t - 1).clamp(0, DMAX - 1)
        pipe = _put(pipe, _index((B, V, DMAX), (nb_t, ovc_c, nd_t)), 1,
                    "add")
        # multicast fan-out: receiver-side, every member copy of a
        # transmitting group receives the flit (one air occupancy, D pipes)
        svm = mc_src.clamp(0, NC - 1)

        def gsv(a):
            return _at(a.reshape(G, NC), svm, inb=True)           # [G,B,V]

        ident_mc = (mc_src >= 0) & gsv(is_mc2) & ss.b_is_rx[..., None] \
            & (mc_id >= 0) & (gsv(mc_id) == mc_id)
        inc_any_mc = ident_mc & gsv(fwd)
        if phy_on:
            # broadcast ARQ: a failing group attempt occupies the channel
            # and the member receivers but delivers to none of them
            inc_mc = ident_mc & gsv(nej_del)
        else:
            inc_mc = inc_any_mc
        d_in_mc = (gsv(lat_t) - 1).clamp(0, DMAX - 1)
        pipe = pipe + (inc_mc[..., None]
                       & (c["d_ar"] == d_in_mc[..., None])).to(pipe.dtype)
        # crossbar: wireless winners do not serialize the receiver
        bu_t = torch.where(nej & ~is_mc2 & (~out_is_wl | L(ss.wl_rx_busy)),
                           out_buf, B)
        busy_until = _put(st.busy_until, _index((B,), (bu_t,)), t + serv_t,
                          "set")
        ser_mc = inc_any_mc & L(ss.wl_rx_busy)
        serv_mc = gsv(serv_t)
        busy_until = torch.where(
            ser_mc.any(-1), t + torch.where(ser_mc, serv_mc, 0).sum(
                -1, dtype=i32), busy_until)
        wl_busy_until = torch.where(
            is_wl_fwd.flatten(1).any(-1),
            t + torch.where(is_wl_fwd, serv_t, 0).amax((1, 2)),
            st.wl_busy_until)
        counts_into = _put(st.counts_into, _index((B,), (torch.where(
            nej_del & ~is_mc2 & (L(post) > 0), out_buf, B),)), 1, "add")
        # broadcast energy is paid once: count only the primary member copy
        prim_buf = L(ss.rx0) + _at(ss.mc_prim, mcid_c2, inb=True)  # [G,B,V]
        counts_into = counts_into + post[:, None] * (
            inc_mc & (b_ids[:, None] == prim_buf)).sum(-1, dtype=i32)
        count_switch = st.count_switch + post * _sum(fwd)
        ctrl_count = st.ctrl_count + post * _sum(first_wl)
        wl_tx_flits = st.wl_tx_flits + post * _sum(is_wl_fwd)
        wl_rx_flits = st.wl_rx_flits + post * (
            _sum(nej_del & ~is_mc2 & out_is_wl) + _sum(inc_mc))
        # the feeding group's tail has been sent: detach the copies
        mc_src = torch.where(ident_mc & gsv(tail), -1, mc_src)

        mem_drop_reads = st.mem_drop_reads
        wl_rate_flits, wl_rate_fail = st.wl_rate_flits, st.wl_rate_fail
        pair_busy = st.pair_busy
        wl_pair_flits, wl_fail_flits = st.wl_pair_flits, st.wl_fail_flits
        freed = tail
        if phy_on:
            # per-(src, dst) WI pacing + energy counters, scatter style:
            # at most one air transmission per pair per cycle, so the set
            # is unique; a multicast sender lands on its (sender, anchor)
            # pair once
            ws_col = ws_bv.expand(G, B, V)
            pw_s = torch.where(is_wl_fwd, ws_col, WMAX)
            ix_pw = _index((WMAX, WMAX), (pw_s, wd_bv))
            pair_busy = _put(pair_busy, ix_pw, t + serv_t, "set")
            wl_pair_flits = _put(wl_pair_flits, ix_pw, L(post), "add")
            pw_sf = torch.where(is_wl_fwd & fail_bv, ws_col, WMAX)
            wl_fail_flits = _put(wl_fail_flits, _index(
                (WMAX, WMAX), (pw_sf, wd_bv)), L(post), "add")
            if living:
                # per-rate-entry attempt counters, attributed to the anchor
                # pair's current entry
                Rr = wl_rate_flits.shape[1]
                rt_bv = _at(st.wl_rate_d, ws_col, wd_bv, inb=True)
                wl_rate_flits = _put(wl_rate_flits, _index((Rr,), (
                    torch.where(is_wl_fwd, rt_bv, Rr),)), L(post), "add")
                wl_rate_fail = _put(wl_rate_fail, _index((Rr,), (
                    torch.where(is_wl_fwd & fail_bv, rt_bv, Rr),)),
                    L(post), "add")
            if mem_on:
                # ARQ drop of a memory request/reply: credit the
                # requester's window and tombstone a dropped request's
                # reply slot
                is_rqd = drop & memrq_bv
                is_repd = drop & ((op_bv == 3) | (op_bv == 4))
                tgt_d = torch.where(is_rqd, psrc_c, torch.where(
                    is_repd, _at(ss.req_src, psrc_c, pidx_c,
                                 inb=True).clamp(0, Nn - 1), Nn))
                outst = _put(outst, _index((Nn,), (tgt_d,)), -1, "add")
                rr_d = torch.where(is_rqd, _at(ss.reply_row, psrc_c, pidx_c,
                                               inb=True).clamp(0, Nn - 1), Nn)
                rs_d = _at(ss.reply_slot, psrc_c, pidx_c, inb=True).clamp(
                    0, Kk - 1)
                dead = _put(dead, _index((Nn, Kk), (rr_d, rs_d)), True,
                            "set")
                # lost read round trips: a dropped read request or reply
                mem_drop_reads = mem_drop_reads + post * _sum(
                    drop & ((op_bv == 1) | (op_bv == 3)))
            # a dropped packet frees the receiver VC its claim held; a
            # dropped multicast group frees every member copy it installed
            db_t = torch.where(drop & ~is_mc2, out_buf, B)
            rx_dropped = _put(torch.zeros_like(drop), _index(
                (B, V), (db_t, ovc_c)), True, "set")
            rx_dropped = rx_dropped | (ident_mc & gsv(drop))
            mc_src = torch.where(rx_dropped, -1, mc_src)
            freed = tail | drop | rx_dropped

        # free VCs whose tail left (phy: plus ARQ drops, both sides)
        pkt_src = torch.where(freed, -1, pkt_src)
        out_vc = torch.where(freed, -1, out_vc)
        out_is_wl = torch.where(freed, False, out_is_wl)
        out_is_ej = torch.where(freed, False, out_is_ej)

        # ---- 3. injection -------------------------------------------------
        N, K = ss.births.shape[1], ss.births.shape[2]
        n_ar = c["n_ar"][None]                                    # [1,N]
        qh = st.q_head.clamp(0, K - 1)                            # [G,N]
        birth_n = _at(ss.births, n_ar, qh, inb=True)
        ib = ss.inj_buf                                           # [G,N]
        ifree = (_at(pkt_src, ib) < 0) & classA                   # [G,N,V]
        ihas = ifree.any(-1)
        ivc = _argmax_bool(ifree)
        # phase gate: a packet injects only once its phase is open
        ph_ok = (ss.n_phases == 0)[:, None] \
            | (_at(ss.phases, n_ar, qh, inb=True) <= cur_phase[:, None])
        if mem_on:
            # reply slots are born by the bank model (rdy); requests gate
            # on the per-core in-flight window
            birth_n = torch.minimum(birth_n, _at(rdy, n_ar, qh, inb=True))
            opq = _at(ss.mem_op, n_ar, qh, inb=True)
            is_tx = (opq == 1) | (opq == 2)
            ph_ok &= ~is_tx | (outst < ss.max_outst[:, None])
        can_new = (st.inj_vc < 0) & (st.q_head < K) & (birth_n <= t) \
            & ihas & ph_ok
        # multicast slots: dests = -(1 + m); route to the group's anchor
        dst_raw = _at(ss.dests, n_ar, qh, inb=True)
        mcv_n = torch.where(dst_raw < 0, -(dst_raw + 1), -1)      # [G,N]
        dst_n = torch.where(dst_raw < 0, _at(ss.mc_route, mcv_n.clamp(
            0, M - 1), inb=True), dst_raw)
        r_oo, r_ob, r_owo, r_owl, r_oej = _route_fields(
            ss, ss.src_switch, dst_n)

        ix_inj = _index((B, V), (torch.where(can_new, ib, B), ivc))

        def iclaim(arr, val):
            return _put(arr, ix_inj, val, "set")

        pkt_src = iclaim(pkt_src, n_ar)
        pkt_idx = iclaim(pkt_idx, st.q_head)
        pkt_dst = iclaim(pkt_dst, dst_n)
        born = iclaim(born, birth_n)
        out_o = iclaim(out_o, r_oo.to(i32))
        out_buf = iclaim(out_buf, r_ob.to(i32))
        out_wo = iclaim(out_wo, r_owo.to(i32))
        out_is_wl = iclaim(out_is_wl, r_owl)
        out_is_ej = iclaim(out_is_ej, r_oej)
        out_vc = iclaim(out_vc, -1)
        phase2 = iclaim(phase2, False)
        mc_id = iclaim(mc_id, mcv_n)
        mc_src = iclaim(mc_src, -1)
        attempt = iclaim(attempt, 0)
        rcvd = iclaim(rcvd, 0)
        sent = iclaim(sent, 0)
        inj_vc = torch.where(can_new, ivc.to(i8), st.inj_vc)
        inj_pushed = torch.where(can_new, 0, st.inj_pushed)
        q_head = st.q_head + can_new.to(i32)
        if mem_on and phy_on:
            # tombstoned reply slots (request ARQ-dropped) never birth:
            # advance past them so the in-order channel keeps flowing
            skip = (st.inj_vc < 0) & (st.q_head < K) \
                & _at(dead, n_ar, qh, inb=True)
            q_head = q_head + skip.to(i32)
        outst_peak = st.outst_peak
        if mem_on:
            outst = outst + (can_new & is_tx).to(i32)
            outst_peak = torch.maximum(outst_peak, outst)

        # push one flit/cycle/core while there is space
        iv_c = inj_vc.clamp(0, V - 1)
        iocc = _at(rcvd, ib, iv_c) - _at(sent, ib, iv_c)
        can_push = (inj_vc >= 0) & (iocc < _at(ss.b_depth, ib))
        rcvd = _put(rcvd, _index((B, V), (torch.where(can_push, ib, B),
                                          iv_c)), 1, "add")
        inj_pushed = inj_pushed + can_push.to(inj_pushed.dtype)
        flits_inj = st.flits_inj + post * _sum(can_push, -1)
        # the source's current packet sits at q_head - 1 (claims advance
        # the head); its per-slot length ends the push burst
        if mem_on:
            plen_cur = _at(ss.lens, n_ar, (q_head - 1).clamp(0, K - 1),
                           inb=True)
        else:
            plen_cur = ss.pkt_len[:, None]
        done = can_push & (inj_pushed >= plen_cur)
        inj_vc = torch.where(done, -1, inj_vc)

        # ---- 4. receiver wake/sleep accounting ([17]) ---------------------
        rx_got = _at(arrive.sum(-1, dtype=i32), rx_ids, inb=True) > 0
        rx_busy = _at(busy_until, rx_ids, inb=True) > t
        rx_active = (rx_got | rx_busy) & (warr < ss.n_wi[:, None])
        n_rx_on = _sum(rx_active, -1)
        awake = torch.where(ss.sleepy, n_rx_on, ss.n_wi)
        awake_cycles = st.awake_cycles + post * awake
        sleep_cycles = st.sleep_cycles + post * (ss.n_wi - awake)

        return SimState(
            pkt_src=pkt_src, pkt_idx=pkt_idx, pkt_dst=pkt_dst, born=born,
            out_o=out_o, out_buf=out_buf, out_wo=out_wo, out_is_wl=out_is_wl,
            out_is_ej=out_is_ej, out_vc=out_vc, phase2=phase2,
            rcvd=rcvd, sent=sent, mc_id=mc_id, mc_src=mc_src,
            attempt=attempt, pipe=pipe, busy_until=busy_until,
            wl_busy_until=wl_busy_until, pair_busy=pair_busy,
            q_head=q_head, inj_vc=inj_vc, inj_pushed=inj_pushed,
            cur_phase=cur_phase, phase_del=phase_del, phase_end=phase_end,
            phase_flits=phase_flits,
            rdy=rdy, dead=dead, outst=outst,
            bank_busy=bank_busy, bank_row=bank_row,
            outst_peak=outst_peak, amat_sum=amat_sum, amat_pkts=amat_pkts,
            mem_reads=mem_reads, mem_writes=mem_writes,
            mem_row_hits=mem_row_hits, mem_q_sum=mem_q_sum,
            mem_svc_sum=mem_svc_sum, mem_flits=mem_flits,
            flits_inj=flits_inj, flits_del=flits_del, pkts_del=pkts_del,
            lat_sum=lat_sum, lat_pkts=lat_pkts, counts_into=counts_into,
            count_switch=count_switch, ctrl_count=ctrl_count,
            wl_tx_flits=wl_tx_flits, wl_rx_flits=wl_rx_flits,
            awake_cycles=awake_cycles, sleep_cycles=sleep_cycles,
            wl_pair_flits=wl_pair_flits, wl_fail_flits=wl_fail_flits,
            wl_pkts=wl_pkts, wl_nacks=wl_nacks, pkts_dropped=pkts_dropped,
            wl_drop_flits=wl_drop_flits, mem_drop_reads=mem_drop_reads,
            wl_serv_d=st.wl_serv_d, wl_perq_d=st.wl_perq_d,
            wl_rate_d=st.wl_rate_d, wl_resel=st.wl_resel,
            wl_rate_flits=wl_rate_flits, wl_rate_fail=wl_rate_fail,
            cycles_run=st.cycles_run, drain_cycle=st.drain_cycle,
        )

    return step


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def run_lanes(ss: SimStatic, st: SimState, B: int, Wout: int, RXW: int,
              budgets: Sequence[int], driver: str = "chunked",
              mem_on: bool = False, phy_on: bool = False,
              drift_on: bool = False, reselect: bool = False) -> SimState:
    """Drive lane-leading ``ss``/``st`` to each lane's budget (``budgets``
    are the lanes' ``ss.cycles`` on the host): the drain-aware chunked
    driver shared with ``simulator.py``, or ``driver="monolithic"``, every
    cycle of one shared budget (the reference's ``_run_mono``)."""
    step = make_step(B, Wout, RXW, mem_on, phy_on, drift_on, reselect)
    with torch.no_grad():
        if driver == "monolithic":
            if len(set(budgets)) != 1:
                raise ValueError("monolithic driver needs one shared cycle "
                                 f"budget; got {sorted(set(budgets))}")
            for t in range(budgets[0]):
                st = step(ss, st, t)
            c = torch.full_like(st.cycles_run, budgets[0])
            return st._replace(cycles_run=c, drain_cycle=c.clone())
        if driver != "chunked":
            raise ValueError(f"unknown driver {driver!r}")
        wfn = make_window_fn(ss, drift_on, reselect) \
            if (drift_on or reselect) else None
        return chunked.run_chunked(lambda s, t: step(ss, s, t), ss, st,
                                   budgets, mem_on, window_fn=wfn)


# --------------------------------------------------------------------------
# host-side packing
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedSim:
    ss: SimStatic
    B: int
    Wout: int
    n_cores: int
    Lw: int
    n_inj: int
    topo: Topology
    rt: RoutingTables
    phy: PhyParams
    sim: SimParams
    RXW: int = 1
    mem_on: bool = False
    Y: int = 1
    BK: int = 1
    phy_on: bool = False
    drift_on: bool = False    # living channel: SNR aging walk
    reselect: bool = False    # living channel: in-scan rate re-selection
    phy_link: object = None

    def flags(self) -> dict:
        """The static flags of the step program."""
        return dict(mem_on=self.mem_on, phy_on=self.phy_on,
                    drift_on=self.drift_on, reselect=self.reselect)


def pack(topo: Topology, rt: RoutingTables, tt: TrafficTable,
         phy: PhyParams, sim: SimParams,
         b_bucket: int = 64, s_bucket: int = 8, r_bucket: int = 64,
         k_bucket: int = 32, phy_spec=None, device=None) -> PackedSim:
    """The reference module's own ``pack``: output arbitration slots
    (``Wout``: wired links, 4 ejection ways per switch, ``WMAX * RXW``
    wireless slots), ``stack_of`` per switch; the host arithmetic in
    numpy, the tables moved to ``device`` at the end."""
    from repro_torch.phy.rates import pack_link_state
    dev = _device.resolve(device)
    Lw = topo.n_links
    n_inj = tt.n_sources
    n_wi = topo.n_wi
    B = _bucket(Lw + n_inj + n_wi, b_bucket)
    S = _bucket(topo.n_switches + 1, s_bucket)
    Wp = len(topo.wl_pairs)
    R = _bucket(Lw + Wp + topo.n_switches, r_bucket)
    medium = phy.wireless_medium
    # output arbitration slots: wired links + ejection (4 ways for memory
    # stacks) + wireless slots (crossbar: one per WI pair; matching/single:
    # one per receiver)
    RXW = max(1, int(phy.wireless_rx_streams)) if medium == "crossbar" else 1
    n_wl_slots = WMAX * RXW
    Wout = _bucket(Lw + EJ_WAYS * S + n_wl_slots, b_bucket)
    N = n_inj
    K = _bucket(tt.k, k_bucket)
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
        b_dst[Lw + n] = tt.src_switch[n]
    rx0 = Lw + n_inj
    serv_wl = phy.wireless_flit_cycles
    for w in range(n_wi):
        b = rx0 + w
        b_dst[b] = topo.wi_switch[w]
        b_lat[b] = pipe_stages + serv_wl
        b_epb[b] = phy.e_wireless_pj_bit
        b_is_rx[b] = True
    # sender WI of any buffer whose switch hosts a WI
    for b in range(rx0):          # rx buffers themselves never send wireless
        b_wi[b] = topo.wi_of_switch[b_dst[b]] \
            if b_dst[b] < topo.n_switches else -1
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

    # lossy PHY: the shared helper packs the same link state for both
    # engines; living channel: drift and/or in-scan re-selection
    pli, phy_on, rx_hold = pack_link_state(
        topo, phy, tt, phy_spec, b_dst, b_depth, b_epb, rx0)
    drift_on = bool(phy_on and phy_spec.drift_amp_db > 0.0)
    reselect = bool(phy_on and phy_spec.reselect)
    living = drift_on or reselect

    # routing lookup tables
    next_out = np.full((S, S), 0, np.int32)
    next_out[:topo.n_switches, :topo.n_switches] = rt.next_out
    o_buf = np.full(R, B, np.int32)
    o_wo = np.full(R, Wout, np.int32)
    o_is_wl = np.zeros(R, bool)
    o_is_ej = np.zeros(R, bool)
    for o in range(Lw):
        o_buf[o] = o
        o_wo[o] = o
    for p in range(Wp):
        o = Lw + p
        src_wi = int(topo.wl_pairs[p, 0])
        dst_wi = int(topo.wl_pairs[p, 1])
        o_buf[o] = rx0 + dst_wi
        # rx sub-channel slot: each receiver serves RXW concurrent streams
        o_wo[o] = Lw + EJ_WAYS * S + dst_wi * RXW + (src_wi % RXW)
        o_is_wl[o] = True
    for s in range(topo.n_switches):
        o = Lw + Wp + s
        o_wo[o] = Lw + s          # base slot; step adds (vc % ways) * S
        o_is_ej[o] = True
    assert rt.n_outputs == Lw + Wp + topo.n_switches
    assert Lw + EJ_WAYS * S + n_wl_slots <= Wout + 1, (Lw, S, n_wl_slots,
                                                       Wout)

    births = np.full((N, K), NO_PKT, np.int32)
    births[:, :tt.k] = tt.births
    dests = np.zeros((N, K), np.int32)
    dests[:, :tt.k] = tt.dests

    # trace tables (phase barriers + multicast groups)
    Pn = getattr(tt, "n_phases", 0)
    Mn = getattr(tt, "n_mc", 0)
    P = _bucket(Pn, 8)
    M = _bucket(Mn, 8)
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
        mc_dst[:Mn] = np.clip(tt.mc_dst, 0, None)
        mc_route[:Mn] = tt.mc_route
        mc_prim[:Mn] = np.argmax(tt.mc_member, axis=1)

    # memory tables (dims mirror simulator.pack, so the two engines'
    # states compare leaf by leaf)
    mem_on = getattr(tt, "mem_op", None) is not None
    dram = (getattr(tt, "dram", None) or DEFAULT_DRAM) if mem_on \
        else DEFAULT_DRAM
    Y = _bucket(topo.n_mem, 4)
    BK = _bucket(dram.n_banks if mem_on else 1, 8)
    NK = (N, K)
    lens = np.full(NK, phy.pkt_flits, np.int32)
    mem = {k: np.zeros(NK, np.int32)
           for k in ("mem_op", "mem_ch", "mem_bank", "mem_row")}
    mem.update({k: np.full(NK, -1, np.int32)
                for k in ("reply_row", "reply_slot", "req_src")})
    mem["req_birth"] = np.full(NK, NO_PKT, np.int32)
    if mem_on:
        lens[:, :tt.k] = tt.lens
        for k in mem:
            mem[k][:, :tt.k] = getattr(tt, k)
    stack_of = np.full(S, -1, np.int32)
    for y, s in enumerate(np.nonzero(topo.is_mem)[0]):
        stack_of[int(s)] = y
    max_outst = dram.max_outstanding if mem_on else 2**30

    def i32s(x):
        return np.int32(x)

    fields = dict(
        b_dst=b_dst, b_serv=b_serv, b_lat=b_lat, b_epb=b_epb,
        b_depth=b_depth, b_wi=b_wi, b_is_rx=b_is_rx, b_ej_ways=b_ej_ways,
        s_pad=i32s(S), next_out=next_out, o_buf=o_buf, o_wo=o_wo,
        o_is_wl=o_is_wl, o_is_ej=o_is_ej, n_wi=i32s(n_wi), rx0=i32s(rx0),
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
        lens=lens, **mem, stack_of=stack_of,
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
    return PackedSim(ss=ss, B=B, Wout=Wout, n_cores=topo.n_cores, Lw=Lw,
                     n_inj=n_inj, topo=topo, rt=rt, phy=phy, sim=sim,
                     RXW=RXW, mem_on=mem_on, Y=Y, BK=BK, phy_on=phy_on,
                     drift_on=drift_on, reselect=reselect, phy_link=pli)


def run(ps: PackedSim, cycles: int | None = None,
        driver: str = "chunked") -> SimState:
    """Run one packed point to ``cycles`` (default: its budget); the
    result has no lane axis.  ``driver="monolithic"`` steps every cycle
    (the differential oracle of the chunked driver)."""
    N, K = ps.ss.births.shape
    budget = int(cycles if cycles is not None else ps.sim.cycles)
    ss = SimStatic(*(x[None] for x in ps.ss))
    ss = ss._replace(cycles=torch.full_like(ss.cycles, budget))
    st = init_state(ps.B, int(N), int(ps.ss.phase_need.shape[0]), int(K),
                    ps.Y, ps.BK, mem_on=ps.mem_on, phy_on=ps.phy_on,
                    living=ps.drift_on or ps.reselect,
                    R=int(ps.ss.wl_serv_r.shape[0]), lanes=1,
                    device=ss.cycles.device)
    out = run_lanes(ss, st, ps.B, ps.Wout, ps.RXW, [budget], driver,
                    **ps.flags())
    return SimState(*(x[0] for x in out))
