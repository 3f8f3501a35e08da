"""WiMCS fabric models applied to ML collective traffic (DESIGN.md §2.2).

The paper evaluates interconnects on three axes — energy, latency,
bandwidth — for three fabrics (substrate serial I/O, interposer wireline,
single-hop wireless).  This module applies exactly that evaluation to a
training/serving step's collective traffic (from the compiled HLO): each
fabric gets a pJ/bit figure, a per-hop latency, and a bandwidth, and the
step's wire bytes are priced on each.

The TPU ICI torus plays the "interposer" (multi-hop neighbor wiring),
inter-pod DCN the "substrate" (serial links), and the paper's mm-wave
medium the hypothetical single-hop in-package fabric.

A copy of ``repro.interconnect.fabric`` (numpy; the JAX package's module
imports no JAX).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    name: str
    pj_per_bit: float
    gbps: float                   # per-link bandwidth
    avg_hops: float               # multi-hop dilution of effective bw


FABRICS = {
    # ICI wireline ~1.3 pJ/bit; 16-wide ring => avg 4 hops on a pod axis
    "ici_wireline": FabricSpec("ici_wireline", 1.3, 400.0, 4.0),
    # PCIe/DCN-class serial I/O (the paper's 5 pJ/bit substrate analogue)
    "dcn_serial": FabricSpec("dcn_serial", 5.0, 100.0, 1.0),
    # paper §III.B: 16 Gbps, 2.3 pJ/bit, single hop between any two nodes
    "wireless_inpackage": FabricSpec("wireless_inpackage", 2.3, 16.0, 1.0),
}


@dataclasses.dataclass
class FabricReport:
    fabric: str
    energy_mj: float
    time_ms: float

    def row(self) -> str:
        return f"{self.fabric},{self.energy_mj:.3f},{self.time_ms:.3f}"


def price_traffic(bytes_per_device: float, n_devices: int,
                  fabric: FabricSpec) -> FabricReport:
    bits = bytes_per_device * 8
    energy = bits * n_devices * fabric.pj_per_bit * 1e-12 * 1e3      # mJ
    time_ms = bytes_per_device * fabric.avg_hops / (fabric.gbps / 8 * 1e9) \
        * 1e3
    return FabricReport(fabric.name, energy, time_ms)


def report_all(bytes_per_device: float, n_devices: int) -> list[FabricReport]:
    return [price_traffic(bytes_per_device, n_devices, f)
            for f in FABRICS.values()]


def _link_energies(topo):
    """Per-directed-link pJ/bit (wired + wireless pair links), exactly the
    cycle engine's ``b_epb`` pricing."""
    import numpy as np

    from repro_torch.core.constants import LinkClass

    phy = topo.phy
    n_pairs = len(topo.wl_pairs)
    epb = np.zeros(topo.n_links + n_pairs)
    for l in range(topo.n_links):
        c = int(topo.link_cls[l])
        mm = float(topo.link_mm[l])
        if c == int(LinkClass.MESH):
            epb[l] = phy.e_wire_pj_bit_mm * mm
        elif c == int(LinkClass.INTERPOSER):
            epb[l] = phy.e_wire_pj_bit_mm * mm + phy.e_ubump_pj_bit
        elif c == int(LinkClass.SERIAL):
            epb[l] = phy.e_serial_pj_bit
        elif c == int(LinkClass.WIDEIO):
            epb[l] = phy.e_wideio_pj_bit
    epb[topo.n_links:] = phy.e_wireless_pj_bit
    return epb


def price_table(topo, tt, pkt_flits: int, flit_bits: int = 32,
                wireless_weight: float = 3.0) -> tuple[float, float]:
    """Analytic wire energy of an emitted ``TrafficTable``: every packet
    priced along its actual forwarding-table path at the cycle engine's
    per-link pJ/bit — ``(total_pj, pj_per_delivered_bit)``.

    Multicasts are priced as the broadcast medium delivers them: the
    pre-air path (one shared-channel crossing) once, plus each member
    copy's post-air mesh leg — so at zero load this total matches the
    cycle-accurate engine's link-energy breakdown almost exactly, and the
    2x acceptance bound (tests / ``benchmarks.fig7_ml_traces``) has real
    teeth.  Feed the per-bit figure through :func:`price_traffic` via a
    ``FabricSpec`` for report-level totals.
    """
    import functools

    import numpy as np

    from repro_torch.core.routing import _all_links, compute_routing
    from repro_torch.core.traffic import NO_PKT

    rt = compute_routing(topo, wireless_weight=wireless_weight)
    src_l, dst_l, _w = _all_links(topo, topo.phy, wireless_weight)
    epb = _link_energies(topo)
    L = len(src_l)

    @functools.lru_cache(maxsize=None)
    def path_e(s: int, d: int) -> float:
        e, cur = 0.0, s
        for _ in range(10_000):
            if cur == d:
                return e
            l = int(rt.next_out[cur, d])
            if l >= L:
                return e
            e += epb[l]
            cur = int(dst_l[l])
        return e

    pkt_bits = pkt_flits * flit_bits
    total, flits = 0.0, 0
    live = tt.births != NO_PKT
    for i in range(tt.n_sources):
        s_sw = int(tt.src_switch[i])
        for k in np.nonzero(live[i])[0]:
            d = int(tt.dests[i, k])
            if d >= 0:
                total += path_e(s_sw, d) * pkt_bits
                flits += pkt_flits
            else:
                m = -(d + 1)
                members = np.nonzero(tt.mc_member[m])[0]
                total += path_e(s_sw, int(tt.mc_route[m])) * pkt_bits
                for w in members:
                    wsw = int(topo.wi_switch[w])
                    total += path_e(wsw, int(tt.mc_dst[m, w])) * pkt_bits
                flits += pkt_flits * len(members)
    return total, total / max(flits * flit_bits, 1)


def spec_from_topology(topo, wireless_weight: float = 3.0,
                       p_mem: float = 0.2) -> FabricSpec:
    """Analytic ``FabricSpec`` for a concrete ``XCYM`` system.

    ``pj_per_bit`` is the routing-weighted mean *wire* energy of a bit
    crossing the system — per-link energies exactly as the cycle engine
    prices them (``simulator.pack``'s ``b_epb``), summed along the
    shortest paths the forwarding tables actually take, averaged over
    core->core pairs (weight ``1-p_mem``) and core->memory pairs
    (``p_mem``).  This makes ``price_traffic`` directly comparable with
    the cycle-accurate engine's link-energy breakdown; the ML-trace
    benchmark (``benchmarks.fig7_ml_traces``) asserts 2x agreement.
    """
    import numpy as np

    from repro_torch.core.routing import _all_links, compute_routing

    phy = topo.phy
    rt = compute_routing(topo, wireless_weight=wireless_weight)
    src, dst, _w = _all_links(topo, phy, wireless_weight)
    L = len(src)
    epb = _link_energies(topo)

    def path(s: int, d: int):
        e, hops, cur = 0.0, 0, s
        while cur != d and hops < 10_000:
            l = int(rt.next_out[cur, d])
            if l >= L:
                break
            e += epb[l]
            hops += 1
            cur = int(dst[l])
        return e, hops

    cores = np.nonzero(topo.is_core)[0]
    mems = np.nonzero(topo.is_mem)[0]
    cc = [path(int(s), int(d)) for s in cores for d in cores if s != d]
    cm = [path(int(s), int(d)) for s in cores for d in mems]
    e_cc = float(np.mean([e for e, _ in cc])) if cc else 0.0
    e_cm = float(np.mean([e for e, _ in cm])) if cm else 0.0
    h_cc = float(np.mean([h for _, h in cc])) if cc else 0.0
    h_cm = float(np.mean([h for _, h in cm])) if cm else 0.0
    pj = (1 - p_mem) * e_cc + p_mem * e_cm
    hops = (1 - p_mem) * h_cc + p_mem * h_cm
    gbps = min(phy.wireless_gbps if topo.n_wi else 1e9,
               phy.flit_bits * phy.clock_ghz)
    return FabricSpec(f"xcym:{topo.name}", pj, gbps, max(hops, 1.0))
