"""Multichip topology construction (paper §III.A, §IV.A).

Builds the ``XCYM`` systems: X multicore chips (each a kx*ky wireline mesh
NoC) + Y in-package DRAM stacks (one base-logic-die switch each), connected
by one of the three fabrics:

- SUBSTRATE:  single chip-chip serial I/O link between the center switches of
  facing chip boundaries; memory stacks attached by 128-bit wide I/O.
- INTERPOSER: the mesh NoC is extended across chip boundaries through the
  interposer metal (every facing boundary switch pair linked) [2]; memory via
  wide I/O.
- WIRELESS:   no wireline inter-chip/memory links; WIs at MAD-optimal cluster
  centers of each chip and one WI on each memory stack's logic die share a
  single 60 GHz channel (one-hop between any WI pair).

All arrays are plain numpy; the simulator converts them to device arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.constants import Fabric, LinkClass, PhyParams


@dataclasses.dataclass
class Topology:
    """A built multichip system.

    Directed links: for every physical bidirectional channel we emit two
    directed links.  Wireless "pair links" exist for routing only; the
    simulator maps them onto per-destination-WI rx buffers + the shared
    channel (see simulator.py).
    """

    name: str
    fabric: Fabric
    phy: PhyParams

    n_switches: int
    pos_mm: np.ndarray            # [S, 2] switch coordinates
    chip_of: np.ndarray           # [S] chip id; memory stacks get ids >= n_chips
    is_core: np.ndarray           # [S] bool: has an attached traffic-generating core
    is_mem: np.ndarray            # [S] bool: memory-stack logic-die switch
    n_chips: int
    n_mem: int

    # directed wired links (MESH / INTERPOSER / SERIAL / WIDEIO)
    link_src: np.ndarray          # [L]
    link_dst: np.ndarray          # [L]
    link_cls: np.ndarray          # [L] LinkClass
    link_mm: np.ndarray           # [L] physical length (energy model)

    # wireless
    wi_switch: np.ndarray         # [W] switch id of each wireless interface
    wl_pairs: np.ndarray          # [Wp, 2] (src_wi, dst_wi) routing pair-links

    def __post_init__(self) -> None:
        self.wi_of_switch = np.full(self.n_switches, -1, np.int32)
        for w, s in enumerate(self.wi_switch):
            self.wi_of_switch[s] = w

    def serving_wi(self) -> np.ndarray:
        """[S] WI id serving each switch: the nearest same-chip WI (-1 if
        the fabric has none).

        This is the cluster structure the paper's WI placement implies
        ([15]: one WI per near-square core cluster, plus one per memory
        stack) recovered geometrically, used by the workload subsystem to
        lower multicast destinations onto receiver WIs.
        """
        out = np.full(self.n_switches, -1, np.int32)
        if not self.n_wi:
            return out
        wi_chip = self.chip_of[self.wi_switch]          # [W]
        wi_pos = self.pos_mm[self.wi_switch]            # [W, 2]
        for s in range(self.n_switches):
            same = np.nonzero(wi_chip == self.chip_of[s])[0]
            if len(same) == 0:
                continue
            d = np.abs(wi_pos[same] - self.pos_mm[s]).sum(axis=1)
            out[s] = same[int(np.argmin(d))]            # lowest id on ties
        return out

    @property
    def n_cores(self) -> int:
        return int(self.is_core.sum())

    @property
    def n_links(self) -> int:
        return len(self.link_src)

    @property
    def n_wi(self) -> int:
        return len(self.wi_switch)

    def describe(self) -> str:
        from collections import Counter
        c = Counter(LinkClass(x).name for x in self.link_cls)
        return (f"{self.name}: {self.n_switches} switches "
                f"({self.n_cores} cores, {self.n_mem} mem), "
                f"{self.n_links} directed wired links {dict(c)}, "
                f"{self.n_wi} WIs")


def _mad_optimal_center(kx: int, ky: int) -> Tuple[int, int]:
    """Minimum-average-distance switch of a kx*ky mesh (paper [15])."""
    return ((kx - 1) // 2, (ky - 1) // 2)


def build_xcym(
    n_chips: int,
    n_mem: int,
    fabric: Fabric,
    phy: PhyParams = PhyParams(),
    total_cores: int = 64,
    wi_cluster_cores: int = 16,
) -> Topology:
    """Build an XCYM system per §IV.

    The combined active processing area is constant (400 mm^2 for the default
    64-core system): 1C4M = one 8x8-mesh chip; 4C4M = 2x2 grid of 4x4-mesh
    chips; 8C4M = 4x2 grid of 4x2-mesh chips.  Memory stacks are mounted on
    both sides (left/right) of the processing array.
    """
    if total_cores % n_chips:
        raise ValueError(f"{total_cores} cores not divisible into {n_chips} chips")
    cores_per_chip = total_cores // n_chips
    # Jointly choose chip mesh (kx, ky) and chip grid (gx, gy) so the global
    # switch array stays near-square (constant combined active area, §IV.C).
    best = None
    for ky in range(1, cores_per_chip + 1):
        if cores_per_chip % ky:
            continue
        kx = cores_per_chip // ky
        for gy in range(1, n_chips + 1):
            if n_chips % gy:
                continue
            gx = n_chips // gy
            w, h = kx * gx, ky * gy
            score = (abs(w - h), abs(kx - ky))
            if best is None or score < best[0]:
                best = (score, kx, ky, gx, gy)
    _, kx, ky, gx, gy = best

    pitch = phy.mesh_hop_mm
    chip_w, chip_h = kx * pitch, ky * pitch
    gap = 2.0  # substrate/interposer gap between dies, mm

    pos: List[Tuple[float, float]] = []
    chip_of: List[int] = []
    sw_id = {}  # (chip, ix, iy) -> switch id
    for c in range(n_chips):
        cgx, cgy = c % gx, c // gx
        ox = cgx * (chip_w + gap)
        oy = cgy * (chip_h + gap)
        for iy in range(ky):
            for ix in range(kx):
                sw_id[(c, ix, iy)] = len(pos)
                pos.append((ox + ix * pitch, oy + iy * pitch))
                chip_of.append(c)
    n_core_switches = len(pos)

    # memory stacks: split between left and right sides of the array
    array_h = gy * (chip_h + gap) - gap
    array_w = gx * (chip_w + gap) - gap
    mem_sw: List[int] = []
    mem_side: List[int] = []  # 0 = left, 1 = right
    for m in range(n_mem):
        side = m % 2
        row = m // 2
        n_side = (n_mem + 1 - side) // 2
        y = (row + 0.5) * array_h / max(n_side, 1)
        x = -gap - 2.0 if side == 0 else array_w + gap + 2.0
        mem_sw.append(len(pos))
        pos.append((x, y))
        chip_of.append(n_chips + m)
        mem_side.append(side)

    S = len(pos)
    pos_mm = np.asarray(pos, np.float64)
    chip_of_a = np.asarray(chip_of, np.int32)
    is_core = np.zeros(S, bool)
    is_core[:n_core_switches] = True
    is_mem = np.zeros(S, bool)
    is_mem[mem_sw] = True

    links: List[Tuple[int, int, int, float]] = []

    def add_bidi(a: int, b: int, cls: LinkClass, mm: float) -> None:
        links.append((a, b, int(cls), mm))
        links.append((b, a, int(cls), mm))

    # Link id ordering matters: ALL X-direction links (intra-chip mesh X +
    # inter-chip X crossings) get lower ids than ALL Y-direction links, so
    # that lowest-link-id tie-breaking in routing.py yields dimension-order
    # (XY) routing across the whole (extended) grid — deadlock-free.
    def chip_grid_xy(c: int) -> Tuple[int, int]:
        return c % gx, c // gx

    inter = fabric in (Fabric.SUBSTRATE, Fabric.INTERPOSER)
    # X: intra-chip
    for c in range(n_chips):
        for iy in range(ky):
            for ix in range(kx):
                if ix + 1 < kx:
                    add_bidi(sw_id[(c, ix, iy)], sw_id[(c, ix + 1, iy)],
                             LinkClass.MESH, pitch)
    # X: inter-chip crossings
    if inter:
        for c in range(n_chips):
            cx, cy = chip_grid_xy(c)
            if cx + 1 < gx:
                c2 = c + 1
                if fabric == Fabric.INTERPOSER:
                    for iy in range(ky):
                        for _ in range(phy.interposer_links_per_pair):
                            add_bidi(sw_id[(c, kx - 1, iy)], sw_id[(c2, 0, iy)],
                                     LinkClass.INTERPOSER,
                                     phy.interposer_hop_mm)
                else:
                    iy = ky // 2
                    add_bidi(sw_id[(c, kx - 1, iy)], sw_id[(c2, 0, iy)],
                             LinkClass.SERIAL, gap)
    # Y: intra-chip
    for c in range(n_chips):
        for iy in range(ky):
            for ix in range(kx):
                if iy + 1 < ky:
                    add_bidi(sw_id[(c, ix, iy)], sw_id[(c, ix, iy + 1)],
                             LinkClass.MESH, pitch)
    # Y: inter-chip crossings
    if inter:
        for c in range(n_chips):
            cx, cy = chip_grid_xy(c)
            if cy + 1 < gy:
                c2 = c + gx
                if fabric == Fabric.INTERPOSER:
                    for ix in range(kx):
                        for _ in range(phy.interposer_links_per_pair):
                            add_bidi(sw_id[(c, ix, ky - 1)], sw_id[(c2, ix, 0)],
                                     LinkClass.INTERPOSER,
                                     phy.interposer_hop_mm)
                else:
                    ix = kx // 2
                    add_bidi(sw_id[(c, ix, ky - 1)], sw_id[(c2, ix, 0)],
                             LinkClass.SERIAL, gap)
    if inter:
        # memory wide I/O: each 4-channel stack attaches through FOUR
        # 128-bit channels to the four nearest boundary switches of the
        # facing chip column (leaf links: cannot create cycles)
        for m in range(n_mem):
            side = mem_side[m]
            ms = mem_sw[m]
            my = pos_mm[ms, 1]
            cgx = 0 if side == 0 else gx - 1
            # chip row whose vertical span contains the stack
            cgy = min(gy - 1, max(0, int(my // (chip_h + gap))))
            c = cgy * gx + cgx
            ix = 0 if side == 0 else kx - 1
            # spread the 4 channel attach points along the facing column so
            # memory traffic does not converge onto one boundary row
            rows = sorted({int(round(r)) for r in
                           np.linspace(0, ky - 1, min(4, ky))})
            for iy in rows:
                add_bidi(ms, sw_id[(c, ix, iy)], LinkClass.WIDEIO, gap + 2.0)

    # wireless interfaces
    wi: List[int] = []
    if fabric == Fabric.WIRELESS:
        clusters = max(1, cores_per_chip // wi_cluster_cores)
        # split each chip mesh into `clusters` near-square tiles; WI at each
        # tile's MAD-optimal center (paper [15])
        ty = int(np.floor(np.sqrt(clusters)))
        while clusters % ty:
            ty -= 1
        tx = clusters // ty
        assert kx % tx == 0 and ky % ty == 0, "cluster tiling must divide mesh"
        cw, ch = kx // tx, ky // ty
        ccx, ccy = _mad_optimal_center(cw, ch)
        for c in range(n_chips):
            for jy in range(ty):
                for jx in range(tx):
                    wi.append(sw_id[(c, jx * cw + ccx, jy * ch + ccy)])
        wi.extend(mem_sw)

    wi_a = np.asarray(wi, np.int32)
    wl_pairs = (np.asarray([(a, b) for a in range(len(wi)) for b in range(len(wi))
                            if a != b], np.int32)
                if len(wi) else np.zeros((0, 2), np.int32))

    la = np.asarray(links, object)
    return Topology(
        name=f"{n_chips}C{n_mem}M({fabric.name.title()})",
        fabric=fabric,
        phy=phy,
        n_switches=S,
        pos_mm=pos_mm,
        chip_of=chip_of_a,
        is_core=is_core,
        is_mem=is_mem,
        n_chips=n_chips,
        n_mem=n_mem,
        link_src=np.asarray([l[0] for l in links], np.int32),
        link_dst=np.asarray([l[1] for l in links], np.int32),
        link_cls=np.asarray([l[2] for l in links], np.int32),
        link_mm=np.asarray([l[3] for l in links], np.float64),
        wi_switch=wi_a,
        wl_pairs=wl_pairs,
    )
