"""Post-run metric extraction (paper §IV definitions); port of
``repro.core.metrics``.

- peak achievable bandwidth per core: delivered flits/cycle/core *
  flit_bits * clock;
- average packet energy: total network energy / delivered packets, from
  the simulator's exact integer event counts (link traversals per link,
  switch traversals, control packets, receiver awake/asleep cycles);
- average packet latency: generation -> tail ejection, packets born after
  warm-up.

The energy terms are reduced on the device in float32 for the whole lane
batch at once.  The sum over links runs in another order than XLA's, so
energies agree with the reference to float32 rounding (the golden harness
holds them to rel 1e-6); every integer counter is exact.  Under the
lossy PHY the wireless link energy is per (src, dst) pair, from the exact
attempt counters and the pair's rate (or, on a living channel, the
per-rate-entry split), in float64 on the host as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.constants import PhyParams, SimParams
from repro_torch.core.simulator import PackedSim, SimState


@dataclasses.dataclass
class Metrics:
    name: str
    offered_load: float        # flits/cycle/core
    throughput: float          # delivered flits/cycle/core
    bw_gbps_core: float        # bits/s/core
    avg_pkt_latency: float     # cycles
    avg_pkt_energy_pj: float   # pJ / packet
    energy_pj_bit: float       # pJ per delivered bit
    pkts_delivered: int
    flits_delivered: int
    flits_injected: int
    energy_breakdown: dict
    # trace-run extensions (zero/empty for open-loop traffic): phase
    # barrier progress and the wireless broadcast occupancy counters
    phases_done: int = 0
    n_phases: int = 0
    phase_end: list = dataclasses.field(default_factory=list)
    phase_flits: list = dataclasses.field(default_factory=list)
    wl_tx_flits: int = 0       # shared-medium occupancies (sender side)
    wl_rx_flits: int = 0       # receptions (multicast: one per member copy)
    # closed-loop memory extensions (zero/empty for open-loop traffic).
    # AMAT = average read round trip, request birth -> reply tail ejection
    # at the requester; its queue/service components are averages over the
    # requests the stacks serviced, and the network share is the remainder
    # (request + reply network time and injection queueing).
    amat_cycles: float = 0.0
    amat_reads: int = 0        # completed read round trips measured
    mem_reads: int = 0         # read requests serviced by the banks
    mem_writes: int = 0
    mem_row_hit_rate: float = 0.0
    mem_queue_cycles: float = 0.0    # avg bank-queue wait per request
    mem_service_cycles: float = 0.0  # avg row hit/miss service per request
    mem_network_cycles: float = 0.0  # AMAT - queue - service
    mem_bw_gbps: float = 0.0         # delivered stack data bandwidth, total
    outst_peak: int = 0              # max in-flight transactions of any core
    per_stack: list = dataclasses.field(default_factory=list)
    # lossy-PHY extensions (zero/empty unless the point packed a
    # PhySweepSpec on a wireless fabric).  Goodput counts only flits
    # that passed CRC and were delivered to a receiver; the air also
    # carried the failing attempts (wl_tx_flits >= delivered).
    wl_goodput_gbps: float = 0.0     # delivered wireless payload bandwidth
    wl_air_cycles: float = 0.0       # channel occupancy: sum attempts*serv
    wl_air_eff: float = 0.0          # delivered flits per air cycle — the
    #                                  policy-attributable goodput (wall-
    #                                  clock goodput also bakes in queueing
    #                                  chaos; see benchmarks/fig9)
    wl_retx_rate: float = 0.0        # NACKs per delivered wireless packet
    wl_pkts: int = 0                 # packets that crossed the air
    wl_nacks: int = 0                # failed attempts (NACK events)
    wl_dropped: int = 0              # packets dropped at max_retx
    wl_dropped_payload: int = 0      # payload flits those drops silently
    #                                  lost (x members for multicast) —
    #                                  nonzero means delivered-data counts
    #                                  under-report the offered work
    mem_dropped_reads: int = 0       # read round trips lost to ARQ drops
    wl_rate_hist: dict = dataclasses.field(default_factory=dict)
    #                                 rate name -> delivered flits (living
    #                                 points: from the in-scan [R] attempt
    #                                 counters, so mid-run re-selections
    #                                 attribute each flit to the rate that
    #                                 actually carried it)
    wl_resel: int = 0                # in-scan rate re-selections
    retx_energy_share: float = 0.0   # failed-attempt share of link energy
    # chunked-execution driver metadata: the lane's semantic
    # cycle budget (what ``throughput`` etc. normalize by) and where the
    # drain-aware while_loop actually stopped simulating (chunk
    # granularity; == cycles_run when the lane never drained early)
    cycles_run: int = 0
    drain_cycle: int = 0

    @property
    def trace_done(self) -> bool:
        """All phases closed AND every payload actually arrived.

        ARQ-exhaustion drops credit the phase barrier so a lossy trace
        drains instead of wedging — but the dropped data never reached
        its receivers, so the run must not report as complete.
        """
        return (self.n_phases > 0 and self.phases_done >= self.n_phases
                and self.wl_dropped_payload == 0)

    @property
    def trace_cycles(self) -> int:
        """Cycle the last phase closed (0 if the trace did not finish)."""
        return self.phase_end[-1] if self.trace_done and self.phase_end else 0

    def row(self) -> str:
        return (f"{self.name},{self.offered_load:.4f},{self.throughput:.4f},"
                f"{self.bw_gbps_core:.3f},{self.avg_pkt_latency:.1f},"
                f"{self.avg_pkt_energy_pj:.0f}")


def phase_durations(m: Metrics) -> list[int]:
    """Per-phase cycle counts (completion-to-completion deltas)."""
    out, prev = [], 0
    for p in range(m.phases_done):
        out.append(m.phase_end[p] - prev)
        prev = m.phase_end[p]
    return out


def collective_summary(m: Metrics, labels: Sequence[str]) -> dict:
    """Aggregate per-phase timings/flits by collective label.

    ``labels`` is the emitted table's ``phase_labels``; fan-out relay
    phases (``<label>/fanout``) fold into their parent collective.
    Returns ``{label: {"cycles": int, "flits": int, "phases": int}}`` in
    first-appearance order — the per-collective view of a trace run.
    """
    durs = phase_durations(m)
    out: dict = {}
    for p, lab in enumerate(labels[:m.phases_done]):
        base = lab.rsplit("/fanout", 1)[0]
        rec = out.setdefault(base, {"cycles": 0, "flits": 0, "phases": 0})
        rec["cycles"] += durs[p]
        rec["flits"] += m.phase_flits[p] if p < len(m.phase_flits) else 0
        rec["phases"] += 1
    return out


def _energy_terms(b_epb, counts_into, count_switch, ctrl_count,
                  awake_cycles, sleep_cycles, bits, e_switch_pj_bit,
                  ctrl_flit_bits_epj, rx_idle, rx_sleep):
    """Per-lane energy components (pJ), float32; every argument is
    lane-leading."""
    f32 = torch.float32
    e_links = (counts_into * b_epb).sum(-1) * bits
    e_switch = count_switch.to(f32) * bits * e_switch_pj_bit
    e_ctrl = ctrl_count.to(f32) * ctrl_flit_bits_epj
    e_rx = awake_cycles.to(f32) * rx_idle + sleep_cycles.to(f32) * rx_sleep
    return e_links, e_switch, e_ctrl, e_rx


def compute_metrics_batch(pss: Sequence[PackedSim], st: SimState,
                          names: Sequence[str],
                          offered_loads: Sequence[float],
                          cycles: int | None = None) -> list[Metrics]:
    """Extract §IV metrics for a lane-leading ``SimState``."""
    dev = st.counts_into.device

    def per_lane(f):
        return torch.tensor([np.float32(f(ps)) for ps in pss],
                            dtype=torch.float32, device=dev)

    terms = _energy_terms(
        torch.stack([ps.ss.b_epb for ps in pss]),
        st.counts_into, st.count_switch, st.ctrl_count,
        st.awake_cycles, st.sleep_cycles,
        per_lane(lambda ps: ps.phy.flit_bits),
        per_lane(lambda ps: ps.phy.e_switch_pj_bit),
        per_lane(lambda ps: ps.phy.ctrl_packet_flits * ps.phy.flit_bits
                 * ps.phy.e_wireless_pj_bit),
        per_lane(lambda ps: ps.phy.rx_idle_pj_cycle),
        per_lane(lambda ps: ps.phy.rx_sleep_pj_cycle))
    el, es, ec, er = (x.cpu().numpy() for x in terms)
    h = {k: getattr(st, k).cpu().numpy() for k in (
        "cycles_run", "pkts_del", "flits_del", "flits_inj", "lat_pkts",
        "lat_sum", "cur_phase", "phase_end", "phase_flits", "wl_tx_flits",
        "wl_rx_flits", "drain_cycle")}
    if any(ps.mem_on for ps in pss):
        h.update({k: getattr(st, k).cpu().numpy() for k in (
            "mem_reads", "mem_writes", "mem_row_hits", "mem_q_sum",
            "mem_svc_sum", "mem_flits", "amat_sum", "amat_pkts",
            "outst_peak")})
    if any(ps.phy_link is not None for ps in pss):
        h.update({k: getattr(st, k).cpu().numpy() for k in (
            "wl_pair_flits", "wl_fail_flits", "wl_rate_flits",
            "wl_rate_fail", "wl_pkts", "wl_nacks", "pkts_dropped",
            "wl_drop_flits", "mem_drop_reads", "wl_resel")})

    out = []
    for g, ps in enumerate(pss):
        phy: PhyParams = ps.phy
        sim: SimParams = ps.sim
        # an explicit analysis window wins; otherwise the lane's own budget
        cyc = cycles or int(h["cycles_run"][g]) or sim.cycles
        window = cyc - sim.warmup
        bits = phy.flit_bits
        energy = float(el[g]) + float(es[g]) + float(ec[g]) + float(er[g])
        pkts = max(int(h["pkts_del"][g]), 1)
        flits = int(h["flits_del"][g])
        lat_pkts = int(h["lat_pkts"][g])
        lat = (float(h["lat_sum"][g]) / lat_pkts if lat_pkts
               else float("nan"))
        thr = flits / window / ps.n_cores
        n_ph = int(ps.ss.n_phases)
        phykw = {}
        pl = ps.phy_link
        if pl is not None:
            # wireless link energy is per pair under the lossy PHY (the rx
            # buffers' b_epb is zeroed at pack): every transmitted flit,
            # failing attempts included, pays its pair's energy per bit
            pf = h["wl_pair_flits"][g].astype(np.float64)
            ff = h["wl_fail_flits"][g].astype(np.float64)
            if ps.drift_on or ps.reselect:
                # a pair's rate entry moves mid-run: energy, air occupancy
                # and the rate histogram come from the per-entry split
                att_r = h["wl_rate_flits"][g].astype(np.float64)
                fail_r = h["wl_rate_fail"][g].astype(np.float64)
                e_pair = float((att_r * pl.epb_r).sum()) * bits
                e_fail = float((fail_r * pl.epb_r).sum()) * bits
                air = float((att_r * pl.serv_r).sum())
                hist = {entry.name: int(att_r[r] - fail_r[r])
                        for r, entry in enumerate(pl.table)
                        if att_r[r] > fail_r[r]}
            else:
                e_pair = float((pf * pl.epb).sum()) * bits
                e_fail = float((ff * pl.epb).sum()) * bits
                air = float((pf * pl.serv).sum())
                hist = {}
                for r, entry in enumerate(pl.table):
                    dfl = int(((pf - ff) * (pl.rate_idx == r)).sum())
                    if dfl:
                        hist[entry.name] = dfl
            energy += e_pair
            wl_pkts = int(h["wl_pkts"][g])
            phykw = dict(
                wl_goodput_gbps=float(h["wl_rx_flits"][g]) * bits
                * phy.clock_ghz / window,
                wl_air_cycles=air,
                wl_air_eff=float((pf - ff).sum()) / max(air, 1.0),
                wl_retx_rate=int(h["wl_nacks"][g]) / max(wl_pkts, 1),
                wl_pkts=wl_pkts,
                wl_nacks=int(h["wl_nacks"][g]),
                wl_dropped=int(h["pkts_dropped"][g]),
                wl_dropped_payload=int(h["wl_drop_flits"][g]),
                mem_dropped_reads=int(h["mem_drop_reads"][g]),
                wl_rate_hist=hist,
                wl_resel=int(h["wl_resel"][g]),
                retx_energy_share=e_fail / max(e_pair, 1e-12),
            )
        memkw = {}
        if ps.mem_on:
            Ym = ps.topo.n_mem
            reads = h["mem_reads"][g][:Ym]
            writes = h["mem_writes"][g][:Ym]
            hits = h["mem_row_hits"][g][:Ym]
            q_sum = h["mem_q_sum"][g][:Ym]
            s_sum = h["mem_svc_sum"][g][:Ym]
            mflits = h["mem_flits"][g][:Ym]
            reqs = max(int((reads + writes).sum()), 1)
            a_pkts = int(h["amat_pkts"][g])
            amat = (float(h["amat_sum"][g]) / a_pkts if a_pkts
                    else float("nan"))
            q_avg = float(q_sum.sum()) / reqs
            s_avg = float(s_sum.sum()) / reqs
            to_gbps = bits * phy.clock_ghz / window
            memkw = dict(
                amat_cycles=amat, amat_reads=a_pkts,
                mem_reads=int(reads.sum()), mem_writes=int(writes.sum()),
                mem_row_hit_rate=float(hits.sum()) / reqs,
                mem_queue_cycles=q_avg, mem_service_cycles=s_avg,
                mem_network_cycles=amat - q_avg - s_avg,
                mem_bw_gbps=float(mflits.sum()) * to_gbps,
                outst_peak=int(h["outst_peak"][g].max()),
                # util: fraction of the stack's full-duplex 4-channel
                # data capacity (4 flits/cycle in + 4 out)
                per_stack=[dict(reads=int(reads[y]), writes=int(writes[y]),
                                row_hits=int(hits[y]),
                                flits=int(mflits[y]),
                                bw_gbps=float(mflits[y]) * to_gbps,
                                util=float(mflits[y]) / window / 8)
                           for y in range(Ym)])
        out.append(Metrics(
            name=names[g],
            offered_load=offered_loads[g],
            throughput=thr,
            bw_gbps_core=thr * bits * phy.clock_ghz,
            avg_pkt_latency=lat,
            avg_pkt_energy_pj=energy / pkts,
            energy_pj_bit=energy / max(flits * bits, 1),
            pkts_delivered=int(h["pkts_del"][g]),
            flits_delivered=flits,
            flits_injected=int(h["flits_inj"][g]),
            energy_breakdown=dict(links=float(el[g]), switch=float(es[g]),
                                  ctrl=float(ec[g]), rx=float(er[g]),
                                  **({"wl": e_pair} if pl is not None
                                     else {})),
            phases_done=int(h["cur_phase"][g]),
            n_phases=n_ph,
            phase_end=[int(x) for x in h["phase_end"][g][:n_ph]],
            phase_flits=[int(x) for x in h["phase_flits"][g][:n_ph]],
            wl_tx_flits=int(h["wl_tx_flits"][g]),
            wl_rx_flits=int(h["wl_rx_flits"][g]),
            cycles_run=cyc,
            drain_cycle=int(h["drain_cycle"][g]),
            **phykw,
            **memkw,
        ))
    return out


def compute_metrics(ps: PackedSim, st: SimState, name: str,
                    offered_load: float, cycles: int | None = None) -> Metrics:
    """Single-state metrics: the batch path with a lane of one."""
    st_b = SimState(*(x[None] for x in st))
    return compute_metrics_batch([ps], st_b, [name], [offered_load],
                                 cycles=cycles)[0]


def inflight_flits(st: SimState) -> int:
    """Flits inside the network (buffers + pipes): conservation checks."""
    occ = torch.where(st.pkt_src >= 0, st.rcvd - st.sent, 0)
    return int(occ.sum()) + int(st.pipe.sum())

