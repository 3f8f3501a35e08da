"""Traffic generation (paper §IV.B-D) and trace emission.

All traffic is pre-generated on the host as per-source packet tables
(birth cycle + destination switch), which keeps the cycle-accurate simulator
free of dynamic allocation:

- ``uniform``: each core generates packets by a Bernoulli process at
  ``load`` flits/cycle/core; with probability ``p_mem`` the destination is a
  (uniformly chosen) memory stack, else a uniformly chosen *other* core
  anywhere in the system (§IV.B).
- ``application``: SynFull-style [20] two-state Markov-modulated processes
  (steady/burst) with per-benchmark memory intensity and hotspot skew,
  standing in for the PARSEC/SPLASH2 traces of §IV.D (DESIGN.md §7.2).
- ``from_trace``: fabric-aware lowering of a ``workloads.Trace`` (phase-
  structured ML collective schedules) into a phase-gated table.  Phases
  become dependency barriers enforced by the simulator; multicast messages
  become *one* shared-medium transmission on wireless fabrics (receiver-set
  delivery, the paper's broadcast advantage) and replicated unicasts on
  wireline.  See the "Trace tables" section below for the encoding.

Trace tables
------------
A trace-emitted ``TrafficTable`` carries four optional extensions:

- ``phases[n, k]``: the phase id of each packet; the simulator injects a
  packet only once its phase is open (all packets of earlier phases
  ejected).  ``phase_need[p]`` is the ejection count that closes phase p.
- multicast groups: ``dests[n, k] = -(1 + m)`` marks packet slots that are
  multicasts of group ``m``.  ``mc_member[m, w]`` is the receiver-WI set,
  ``mc_dst[m, w]`` the final destination switch of the copy delivered at
  WI ``w`` (one representative per receiver cluster; additional same-
  cluster destinations are relayed by the representative in an emitted
  local fan-out phase), and ``mc_route[m]`` the pre-air routing anchor
  (switch of the lowest member WI).

Memory tables (see memory/table.py)
-----------------------------------
A closed-loop table additionally carries per-slot packet lengths
(``lens``) and the memory-transaction encoding: ``mem_op`` marks read
requests / writes / their paired replies, ``mem_ch``/``mem_bank``/
``mem_row`` are the DRAM coordinates, ``reply_row``/``reply_slot`` link
each request to its pre-allocated reply slot (birth-gated in-engine on
request delivery + bank service), and ``req_src``/``req_birth`` let a
reply credit the requester's ``max_outstanding`` window and anchor the
AMAT measurement.  ``dram`` holds the stack timing parameters
(``memory.model.DramTimingParams``).  All fields are ``None`` for
open-loop tables, which stay byte-identical through the engine changes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.constants import WMAX as MC_WMAX   # multicast mask width
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class AppTrafficModel:
    """Two-state MMP parameters for one benchmark (SynFull-style)."""

    name: str
    p_mem: float          # fraction of packets that are memory accesses
    steady_load: float    # flits/cycle/core in steady state
    burst_load: float     # flits/cycle/core in bursts
    p_enter_burst: float  # per-cycle steady->burst transition prob
    p_exit_burst: float   # per-cycle burst->steady transition prob
    hotspot_skew: float   # Zipf-ish concentration of core destinations


# Calibrated to the published off-chip-traffic orderings of §IV.D: memory-
# intensive benchmarks (canneal, radix, fft) have high p_mem; compute-bound
# ones (bodytrack, barnes) are lighter and burstier.
APP_MODELS = {
    "canneal":      AppTrafficModel("canneal", 0.55, 0.08, 0.30, 0.004, 0.05, 0.6),
    "fluidanimate": AppTrafficModel("fluidanimate", 0.30, 0.05, 0.20, 0.003, 0.06, 0.8),
    "radix":        AppTrafficModel("radix", 0.60, 0.10, 0.35, 0.005, 0.04, 0.4),
    "lu":           AppTrafficModel("lu", 0.40, 0.06, 0.25, 0.003, 0.05, 0.7),
    "fft":          AppTrafficModel("fft", 0.50, 0.09, 0.30, 0.004, 0.05, 0.5),
    "barnes":       AppTrafficModel("barnes", 0.25, 0.04, 0.15, 0.002, 0.06, 0.9),
    "bodytrack":    AppTrafficModel("bodytrack", 0.20, 0.03, 0.12, 0.002, 0.07, 1.0),
    "dedup":        AppTrafficModel("dedup", 0.35, 0.07, 0.28, 0.004, 0.05, 0.6),
}


@dataclasses.dataclass
class TrafficTable:
    """Pre-generated packets: per source, K slots ordered by birth.

    The four optional trailing fields are the trace-table extensions
    (phase barriers + multicast groups) documented in the module
    docstring; they are ``None`` for the synthetic generators.
    """

    src_switch: np.ndarray   # [N_src] switch id of each source core
    births: np.ndarray       # [N_src, K] cycle (INT32_MAX = no packet)
    dests: np.ndarray        # [N_src, K] destination switch, or -(1+m)
    offered_load: float      # flits/cycle/core actually offered
    # trace extensions (phase barriers + multicast groups)
    phases: Optional[np.ndarray] = None      # [N_src, K] phase id
    phase_need: Optional[np.ndarray] = None  # [P] ejections closing phase p
    mc_member: Optional[np.ndarray] = None   # [M, WMAX] bool receiver WIs
    mc_dst: Optional[np.ndarray] = None      # [M, WMAX] copy dst switch
    mc_route: Optional[np.ndarray] = None    # [M] pre-air routing anchor
    phase_labels: Optional[list] = None      # [P] collective label per phase
    # memory tables (closed-loop request/reply; see module docstring)
    lens: Optional[np.ndarray] = None        # [N_src, K] packet length, flits
    mem_op: Optional[np.ndarray] = None      # [N_src, K] MEM_* op code
    mem_ch: Optional[np.ndarray] = None      # [N_src, K] pseudo-channel
    mem_bank: Optional[np.ndarray] = None    # [N_src, K] bank
    mem_row: Optional[np.ndarray] = None     # [N_src, K] DRAM row
    reply_row: Optional[np.ndarray] = None   # [N_src, K] paired reply source
    reply_slot: Optional[np.ndarray] = None  # [N_src, K] paired reply slot
    req_src: Optional[np.ndarray] = None     # [N_src, K] requester source row
    req_birth: Optional[np.ndarray] = None   # [N_src, K] request birth cycle
    dram: Optional[object] = None            # memory.model.DramTimingParams

    @property
    def n_sources(self) -> int:
        return len(self.src_switch)

    @property
    def has_mem(self) -> bool:
        """True for closed-loop tables (memory request/reply slots)."""
        return self.mem_op is not None

    @property
    def k(self) -> int:
        return self.births.shape[1]

    @property
    def n_phases(self) -> int:
        return 0 if self.phase_need is None else len(self.phase_need)

    @property
    def n_mc(self) -> int:
        return 0 if self.mc_member is None else len(self.mc_member)


NO_PKT = np.int32(2**31 - 1)


def _pack_arrivals(arr: np.ndarray, k: int) -> np.ndarray:
    """[N, C] bool -> [N, k] first-k arrival cycles (NO_PKT padded).

    One vectorized pass: ``np.nonzero`` on the 2-D mask walks row-major, so
    each row's hits come out in ascending cycle order already; the rank of
    a hit within its row is its global position minus the row's cumulative
    start.  (The per-row Python loop this replaces dominated host-side
    setup for long-cycle traces.)
    """
    n, c = arr.shape
    births = np.full((n, k), NO_PKT, np.int32)
    rows, cols = np.nonzero(arr)
    if len(rows) == 0:
        return births
    counts = np.bincount(rows, minlength=n)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    rank = np.arange(len(rows)) - starts[rows]
    keep = rank < k
    births[rows[keep], rank[keep]] = cols[keep]
    return births


def _sample_dests(rng: np.random.Generator, topo: Topology, n: int, k: int,
                  p_mem: float, hotspot_skew: float = 1.0) -> np.ndarray:
    core_sw = np.nonzero(topo.is_core)[0].astype(np.int32)
    mem_sw = np.nonzero(topo.is_mem)[0].astype(np.int32)
    n_cores = len(core_sw)

    is_memref = rng.random((n, k)) < p_mem
    mem_pick = mem_sw[rng.integers(0, len(mem_sw), (n, k))]

    # core destinations: uniform over *other* cores, optionally skewed
    # (hotspot_skew < 1 concentrates traffic on low-index cores, modelling
    # shared-data hotspots of cache-coherent applications)
    if hotspot_skew >= 0.999:
        j = rng.integers(0, n_cores - 1, (n, k))
    else:
        w = (np.arange(1, n_cores) ** (-(1.0 - hotspot_skew) * 2.0)).astype(np.float64)
        w /= w.sum()
        j = rng.choice(n_cores - 1, size=(n, k), p=w)
    # skip self: for source i, candidate list is all cores except i
    src_idx = np.arange(n)[:, None]
    j = np.where(j >= src_idx, j + 1, j)
    core_pick = core_sw[j]
    return np.where(is_memref, mem_pick, core_pick).astype(np.int32)


def uniform_random(topo: Topology, load: float, p_mem: float, cycles: int,
                   pkt_flits: int, seed: int = 0) -> TrafficTable:
    """§IV.B uniform random traffic at `load` flits/cycle/core."""
    rng = np.random.default_rng(seed)
    core_sw = np.nonzero(topo.is_core)[0].astype(np.int32)
    n = len(core_sw)
    p_pkt = min(1.0, load / pkt_flits)
    arr = rng.random((n, cycles)) < p_pkt
    k = max(8, int(np.ceil(cycles / pkt_flits)) + 8)
    births = _pack_arrivals(arr, k)
    dests = _sample_dests(rng, topo, n, k, p_mem)
    return TrafficTable(core_sw, births, dests, offered_load=p_pkt * pkt_flits)


def from_trace(topo: Topology, trace, pkt_flits: int, flit_bits: int = 32,
               bytes_scale: float = 1.0, dram=None) -> TrafficTable:
    """Lower a ``workloads.Trace`` onto ``topo`` as a phase-gated table.

    Fabric-aware multicast lowering (the tentpole semantics):

    - wireline fabrics (no WIs): a multicast to D nodes is D replicated
      unicast packet streams — every copy pays its full wire path;
    - wireless fabric: destinations on the sender's own chip stay local
      mesh unicasts; remote destinations are grouped by *serving WI*
      (``Topology.serving_wi``) into one multicast group — the packet
      crosses the shared medium once and is delivered to every member WI's
      rx buffer.  Each member delivers to one representative destination
      switch; further same-cluster destinations are relayed by the
      representative in an appended ``<label>/fanout`` phase (local mesh
      traffic on every fabric, so the comparison stays fair).

    Memory ops: a ``read``/``write`` message becomes one
    request/reply transaction per payload packet, lowered through the
    ``DeviceMap`` residency mapping: the request targets the stack's
    base-logic-die switch with deterministic (channel, bank, row)
    coordinates — identical across fabrics — and the service-gated reply
    slot lives in the stack's per-channel source row.  Both ejections
    (request at the stack, reply at the device) count toward the phase's
    barrier, so a phase completes only when its round trips complete.

    Sources are all logical devices followed by all memory stacks, in that
    order, regardless of whether they send — keeping N identical across
    the three fabrics so one trace's three points share a sweep batch.
    Traces with memory ops append (MEM_CH - 1) extra per-channel reply
    rows per stack after that prefix (the stack's own row doubles as its
    channel-0 reply row); traces without them keep the historical layout.
    """
    from repro_torch.memory.model import DEFAULT_DRAM, MEM_CH
    from repro_torch.memory.table import MEM_READ, MEM_WRITE, MemTableBuilder
    from repro_torch.workloads.mapping import DeviceMap
    from repro_torch.workloads.trace import is_mem_node, mem_stack

    dm = DeviceMap(topo, trace.n_devices)
    n_dev = trace.n_devices
    n_mem = len(dm.mem_switch)
    has_mem = any(m.is_mem_op for p in trace.phases for m in p.messages)
    dram = dram or DEFAULT_DRAM
    src_switch = [np.asarray(dm.dev_switch), np.asarray(dm.mem_switch)]
    if has_mem:         # per-channel reply rows (stack row = channel 0)
        src_switch.append(np.repeat(dm.mem_switch, MEM_CH - 1))
    src_switch = np.concatenate(src_switch).astype(np.int32)

    def src_index(node: int) -> int:
        return n_dev + mem_stack(node) if is_mem_node(node) else node

    def mem_row_of(stack: int, ch: int) -> int:
        if ch == 0:
            return n_dev + stack
        return n_dev + n_mem + stack * (MEM_CH - 1) + (ch - 1)

    assert topo.n_wi <= MC_WMAX
    pkt_bytes = pkt_flits * flit_bits / 8
    use_wl = topo.n_wi > 0
    serving = dm.serving_wi
    b = MemTableBuilder(src_switch, dm.mem_switch, pkt_flits, dram,
                        mem_row_of=mem_row_of)
    phase_need: list[int] = []
    phase_labels: list[str] = []
    mc_key_to_id: dict = {}
    mc_groups: list[tuple] = []     # (members, {wi: dst_switch})

    def emit(si: int, pid: int, dest: int, npk: int) -> None:
        for _ in range(npk):
            b.plain(si, dest, phase=pid)

    for ph in trace.phases:
        pid = len(phase_need)
        need = 0
        relays: list[tuple] = []
        for msg in ph.messages:
            npk = max(1, int(np.ceil(msg.bytes_ * bytes_scale / pkt_bytes)))
            si = src_index(msg.src)
            if msg.is_mem_op:
                # one round trip per payload packet; coordinates are a
                # deterministic hash of (device, stack, packet) so every
                # fabric sees the identical address stream
                stack = mem_stack(msg.dsts[0])
                op = MEM_READ if msg.op == "read" else MEM_WRITE
                rdst = dm.node_switch(msg.src)
                for j in range(npk):
                    h = msg.src * 40503 + stack * 9176 + j
                    ch = h % MEM_CH
                    bank = (h // MEM_CH) % dram.n_banks
                    drow = (h // (MEM_CH * dram.n_banks)) % dram.n_rows
                    b.request(si, op, stack, ch, bank, drow,
                              reply_dest=rdst, phase=pid)
                need += 2 * npk
                continue
            s_chip = topo.chip_of[dm.node_switch(msg.src)]
            remote = []
            for d in msg.dsts:
                if use_wl and len(msg.dsts) > 1 \
                        and topo.chip_of[dm.node_switch(d)] != s_chip:
                    remote.append(d)
                else:
                    emit(si, pid, dm.node_switch(d), npk)
                    need += npk
            if len(remote) == 1:
                emit(si, pid, dm.node_switch(remote[0]), npk)
                need += npk
            elif remote:
                wi_map: dict[int, list] = {}
                for d in remote:
                    w = int(serving[dm.node_switch(d)])
                    assert w >= 0, "remote multicast dst without serving WI"
                    wi_map.setdefault(w, []).append(d)
                members = tuple(sorted(wi_map))
                reps = {w: dm.node_switch(wi_map[w][0]) for w in members}
                key = (members, tuple(reps[w] for w in members))
                m = mc_key_to_id.get(key)
                if m is None:
                    m = mc_key_to_id[key] = len(mc_groups)
                    mc_groups.append((members, reps))
                emit(si, pid, -(1 + m), npk)
                need += npk * len(members)
                for w in members:
                    for d in wi_map[w][1:]:
                        relays.append((wi_map[w][0], d, npk))
        phase_need.append(need)
        phase_labels.append(ph.label)
        if relays:
            pid2 = len(phase_need)
            need2 = 0
            for rep, d, npk in relays:
                emit(src_index(rep), pid2, dm.node_switch(d), npk)
                need2 += npk
            phase_need.append(need2)
            phase_labels.append(ph.label + "/fanout")

    M = len(mc_groups)
    mc_member = np.zeros((max(M, 1), MC_WMAX), bool)
    mc_dst = np.full((max(M, 1), MC_WMAX), -1, np.int32)
    mc_route = np.zeros(max(M, 1), np.int32)
    for m, (members, reps) in enumerate(mc_groups):
        for w in members:
            mc_member[m, w] = True
            mc_dst[m, w] = reps[w]
        mc_route[m] = topo.wi_switch[members[0]]

    return b.build(
        offered_load=0.0,
        phase_need=np.asarray(phase_need, np.int32),
        phase_labels=phase_labels,
        mc_member=mc_member if M else None,
        mc_dst=mc_dst if M else None,
        mc_route=mc_route if M else None)


def application(topo: Topology, model: AppTrafficModel, cycles: int,
                pkt_flits: int, seed: int = 0, load_scale: float = 1.0,
                closed_loop: bool = False, dram=None) -> TrafficTable:
    """§IV.D application-specific traffic via a two-state MMP.

    With ``closed_loop=True`` the model's ``p_mem`` fraction is
    reinterpreted as round-trip DRAM *reads*: every memory-destined
    packet becomes a short read request whose full-size data reply is
    generated by the stack after its bank-model service delay, and the
    issuing core is capped at ``dram.max_outstanding`` in-flight
    transactions.  The default is the historical open-loop
    interpretation — memory packets are one-way sinks — and its tables
    are byte-identical to what this generator always produced, so the
    fig2–fig6 goldens pin the escape hatch.
    """
    rng = np.random.default_rng(seed)
    core_sw = np.nonzero(topo.is_core)[0].astype(np.int32)
    n = len(core_sw)
    # simulate the 2-state Markov chain per core (vectorized over cores)
    burst = np.zeros(n, bool)
    arr = np.zeros((n, cycles), bool)
    u = rng.random((n, cycles))
    tr = rng.random((n, cycles))
    for t in range(cycles):
        p = np.where(burst, model.burst_load, model.steady_load) * load_scale / pkt_flits
        arr[:, t] = u[:, t] < p
        burst = np.where(burst, tr[:, t] >= model.p_exit_burst,
                         tr[:, t] < model.p_enter_burst)
    k = max(8, int(arr.sum(1).max()) + 4)
    births = _pack_arrivals(arr, k)
    dests = _sample_dests(rng, topo, n, k, model.p_mem, model.hotspot_skew)
    offered = float(arr.mean()) * pkt_flits
    if not closed_loop:
        return TrafficTable(core_sw, births, dests, offered_load=offered)
    return _close_loop(topo, core_sw, births, dests, offered, pkt_flits,
                       dram, seed)


def _close_loop(topo: Topology, core_sw, births, dests, offered,
                pkt_flits: int, dram, seed: int) -> TrafficTable:
    """Rebuild an open-loop (births, dests) table with every memory-stack
    destination converted into a request/reply read transaction.

    Requests are walked in global birth order so each (stack, channel)
    reply row's in-order injection tracks expected arrival order; the
    DRAM coordinates come from an independent stream, leaving the base
    arrival/destination draws untouched.
    """
    from repro_torch.memory.model import DEFAULT_DRAM, MEM_CH
    from repro_torch.memory.table import (MEM_READ, MemTableBuilder,
                                    mem_source_rows)
    dram = dram or DEFAULT_DRAM
    mem_sw = np.nonzero(topo.is_mem)[0].astype(np.int32)
    stack_of = {int(s): y for y, s in enumerate(mem_sw)}
    b = MemTableBuilder(mem_source_rows(core_sw, mem_sw), mem_sw,
                        pkt_flits, dram)
    live = births != NO_PKT
    rows_i, ks = np.nonzero(live)
    order = np.lexsort((rows_i, births[live]))
    is_mem_dst = np.isin(dests[live], mem_sw)
    rng2 = np.random.default_rng(seed + 0x5EED)
    n_req = int(is_mem_dst.sum())
    chans = rng2.integers(0, MEM_CH, n_req)
    banks = rng2.integers(0, dram.n_banks, n_req)
    rws = rng2.integers(0, dram.n_rows, n_req)
    j = 0
    for idx in order:
        i, k = int(rows_i[idx]), int(ks[idx])
        d, t = int(dests[i, k]), int(births[i, k])
        if d in stack_of:
            b.request(i, MEM_READ, stack_of[d], int(chans[j]),
                      int(banks[j]), int(rws[j]),
                      reply_dest=int(core_sw[i]), birth=t)
            j += 1
        else:
            b.plain(i, d, birth=t)
    return b.build(offered)
