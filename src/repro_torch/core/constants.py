"""Paper constants (Shamim et al. 2017, §IV) and PHY/simulation parameters.

All energies in pJ, times in core-clock cycles (2.5 GHz => 0.4 ns/cycle),
lengths in mm, bandwidths in Gbps.
"""
from __future__ import annotations

import dataclasses
import enum


# Max wireless interfaces the simulators' padded tables support — shared by
# both engines' state layouts and the trace-table multicast masks
# (traffic.from_trace), which must agree on the receiver-set width.
WMAX = 16


class LinkClass(enum.IntEnum):
    """Physical classes of links in the multichip system."""

    MESH = 0        # intra-chip wireline mesh hop (single-cycle, §IV)
    INTERPOSER = 1  # chip-boundary crossing through interposer metal [2]
    SERIAL = 2      # chip-chip high-speed serial I/O, 15 Gbps, 5 pJ/bit [8]
    WIDEIO = 3      # memory wide I/O, 128-bit @ 1 GHz = 128 Gbps, 6.5 pJ/bit [19]
    WIRELESS = 4    # 60 GHz mm-wave OOK, 16 Gbps, 2.3 pJ/bit [6]
    INJECT = 5      # core -> local switch injection channel


class Fabric(enum.IntEnum):
    """The three §IV.A architectures."""

    SUBSTRATE = 0
    INTERPOSER = 1
    WIRELESS = 2


class MacMode(enum.IntEnum):
    """Wireless medium access control variants (§III.D)."""

    CONTROL_PACKET = 0  # proposed: partial-packet 3-tuple control packets
    TOKEN = 1           # baseline [7]: whole-packet token passing


@dataclasses.dataclass(frozen=True)
class PhyParams:
    """Physical-layer constants. Defaults are the paper's §IV values.

    Energy calibration (DESIGN.md §7.1): the paper's RTL-synthesis switch
    numbers are not public; ``e_switch_pj_bit`` / ``e_wire_pj_bit_mm`` are set
    to published 65 nm figures consistent with the paper's reference [18].
    """

    clock_ghz: float = 2.5
    flit_bits: int = 32
    pkt_flits: int = 64
    num_vcs: int = 8
    buf_depth: int = 16
    switch_stages: int = 3          # 3-stage pipelined switch [18]

    # Wireline energy model (65 nm)
    e_switch_pj_bit: float = 0.60   # switch traversal (buffer rw + xbar + arb)
    e_wire_pj_bit_mm: float = 0.20  # on-chip global wire
    mesh_hop_mm: float = 2.5        # 10 mm die / 4x4 mesh
    interposer_hop_mm: float = 4.0  # boundary crossing via interposer + ubumps
    e_ubump_pj_bit: float = 0.40    # ubump + TSV overhead per crossing
    # interposer metal = long RC-limited global wires through ubumps; they
    # cannot be clocked at the on-die mesh rate [2,3] => 2 cycles/flit
    interposer_flit_cycles: int = 2
    # parallel interposer links per facing boundary switch pair ("why pay
    # for more wires when you can get them for free" [2]); ablation knob
    interposer_links_per_pair: int = 1

    # Off-chip I/O (paper §IV.A)
    serial_gbps: float = 15.0
    e_serial_pj_bit: float = 5.0
    wideio_gbps: float = 128.0
    e_wideio_pj_bit: float = 6.5

    # Wireless PHY (paper §III.B / §IV)
    wireless_gbps: float = 16.0
    e_wireless_pj_bit: float = 2.3
    # Effective flit service time on the shared channel, in cycles.  The
    # strict 16 Gbps serialization of a 32-bit flit @2.5 GHz is 5 cycles;
    # the paper's reported bandwidth results are only reachable with a
    # burst-mode channel near one flit/cycle (DESIGN.md §7).  Both modes are
    # benchmarked; default = burst (paper-results-faithful).
    wireless_flit_cycles: int = 1
    # Wireless medium concurrency model (DESIGN.md §7):
    #   "crossbar": every (src WI, dst WI) pair is an independent virtual
    #               channel (idealized multi-channel/FDMA+SDM medium) —
    #               required to reach the paper's reported bandwidth/latency
    #               results; the *default*.
    #   "matching": one stream per receiver + one flit/cycle per sender
    #               (bipartite-matching medium).
    #   "single":   the strict single shared 16 Gbps channel of §III.B
    #               (one flit in the air per `wireless_flit_cycles`) —
    #               physics-faithful ablation.
    wireless_medium: str = "crossbar"
    # concurrent receive streams per WI transceiver in crossbar mode
    # (sub-channels of the 16 GHz mm-wave band; 4 matches the 4-channel
    # memory stacks)
    wireless_rx_streams: int = 4
    ctrl_packet_flits: int = 2      # control packet = hdr + up to 8 3-tuples
    rx_idle_pj_cycle: float = 4.0   # awake-but-idle receiver (≈10 mW @2.5 GHz)
    rx_sleep_pj_cycle: float = 0.4  # power-gated receiver leakage [17]

    def cycles_per_flit(self, gbps: float) -> int:
        ns = self.flit_bits / gbps
        return max(1, round(ns * self.clock_ghz))

    @property
    def serial_flit_cycles(self) -> int:
        return self.cycles_per_flit(self.serial_gbps)      # 5 @ defaults

    @property
    def wideio_flit_cycles(self) -> int:
        return self.cycles_per_flit(self.wideio_gbps)      # 1 @ defaults


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation run parameters (paper §IV: 10k cycles, 1k warm-up)."""

    cycles: int = 10_000
    warmup: int = 1_000
    mac: MacMode = MacMode.CONTROL_PACKET
    sleepy_rx: bool = True
    max_tuples: int = 8             # 3-tuples per control packet <= output VCs
    seed: int = 0


DEFAULT_PHY = PhyParams()
DEFAULT_SIM = SimParams()
