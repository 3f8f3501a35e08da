"""Rate/modulation table and the static per-link rate-selection pass.

The table spans the paper's 16 Gbps OOK channel down to two derated
fallbacks.  Halving the rate doubles the per-bit integration time, which
(a) doubles the effective SNR (``gain`` — robustness), (b) doubles the
flit serialization time (``serv_scale`` — the engines' per-link
``wireless_flit_cycles``), and (c) doubles the energy per bit at fixed
TX power (``epb_scale``).

Rate selection is per link — the "engineer the channel and adapt to it"
policy (Timoneda et al. 2019).  ``select_rates`` walks the table
fastest-first and keeps the fastest entry whose expected goodput (rate
derated by the expected ARQ attempts, ``rate * (1 - PER)``) is at least
the next, slower entry's — i.e. it stops exactly when slowing down
would stop paying.  The argmax runs over *integer-quantized* goodput
(``goodput_q``, ``GP_SCALE`` steps of a Gbps): those are exactly the
integers the engines embed for in-scan re-selection on a living channel
(``phy.living``), so the one-shot host pass and the per-window device
pass agree bitwise on a static channel.  ``oracle_fixed_rate`` is the
strongest *non-adaptive* baseline: the single table entry maximizing
total expected goodput over every used link.

``link_tables`` packages the result for the engines: padded
``[WMAX, WMAX]`` per-pair tables of flit service cycles, quantized
packet-error thresholds (16-bit, compared against the CRC hash of
``phy.retx``) and energy per bit, plus the per-entry ``[R, ...]``
tables (service cycles, PER thresholds, quantized goodput, SNR gains)
the living-channel window updates re-derive rates from.  Multicast
tables are fully supported: the engines run broadcast ARQ
(per-member CRC outcomes, worst-link group retransmission) over the
same per-pair tables.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.constants import WMAX, PhyParams
from repro_torch.core.topology import Topology
from repro_torch.phy.channel import (PhySweepSpec, ber_from_snr, link_snr_db,
                               per_packet)

PER_Q = 16                    # PER quantization: threshold in [0, 2^16]
GP_SCALE = 1 << 20            # goodput quantization: int steps per 2^-20 Gbps


@dataclasses.dataclass(frozen=True)
class RateEntry:
    """One rate/modulation point of the link adaptation table."""

    name: str
    gbps: float
    serv_scale: int      # x wireless_flit_cycles (serialization time)
    gain: float          # effective-SNR multiplier (processing gain)
    epb_scale: float     # x e_wireless_pj_bit (fixed TX power, longer bits)


# Fastest first — the order the selection pass walks.
DEFAULT_RATE_TABLE = (
    RateEntry("16g", 16.0, 1, 1.0, 1.0),
    RateEntry("8g", 8.0, 2, 2.0, 2.0),
    RateEntry("4g", 4.0, 4, 4.0, 4.0),
)


@dataclasses.dataclass
class PhyLinkInfo:
    """Per-link PHY tables of one packed point (host + engine views).

    ``serv``/``perq`` are the padded int32 tables the engines embed;
    ``rate_idx``/``per``/``epb`` stay host-side for metrics (selected
    rate histogram, retransmission-energy share) and tests.
    """

    spec: PhySweepSpec
    table: tuple            # the RateEntry tuple used
    n_wi: int
    rate_idx: np.ndarray    # [WMAX, WMAX] int32 selected table entry
    serv: np.ndarray        # [WMAX, WMAX] int32 flit cycles on that link
    perq: np.ndarray        # [WMAX, WMAX] int32 16-bit PER threshold
    per: np.ndarray         # [WMAX, WMAX] float exact packet error rate
    epb: np.ndarray         # [WMAX, WMAX] float pJ/bit on that link
    snr_db: np.ndarray      # [n_wi, n_wi] float
    # per-entry tables for the living-channel window updates (phy.living)
    serv_r: np.ndarray      # [R] int32 flit cycles of each table entry
    epb_r: np.ndarray       # [R] float pJ/bit of each table entry
    gain_r: np.ndarray      # [R] float32 processing gain of each entry
    gbps_r: np.ndarray      # [R] float32 line rate of each entry
    perq_r: np.ndarray      # [R, WMAX, WMAX] int32 PER threshold per entry
    gp_q: np.ndarray        # [R, WMAX, WMAX] int32 quantized goodput
    snr_pad: np.ndarray     # [WMAX, WMAX] float32 padded SNR map


def rate_per_matrix(snr_db: np.ndarray, packet_bits: int,
                    table=DEFAULT_RATE_TABLE) -> np.ndarray:
    """[R, W, W] packet error rate of every table entry on every link."""
    return np.stack([per_packet(ber_from_snr(snr_db, e.gain), packet_bits)
                     for e in table])


def expected_goodput(per_r: np.ndarray, table=DEFAULT_RATE_TABLE
                     ) -> np.ndarray:
    """[R, W, W] expected goodput: rate derated by expected attempts.

    Successful delivery takes ``1 / (1 - PER)`` expected attempts, so a
    link at rate R delivers ``R * (1 - PER)`` useful bits per unit
    air time.
    """
    rates = np.asarray([e.gbps for e in table])
    return rates[:, None, None] * (1.0 - per_r)


def goodput_q(per_r: np.ndarray, table=DEFAULT_RATE_TABLE) -> np.ndarray:
    """[R, W, W] int32 expected goodput in ``1 / GP_SCALE`` Gbps steps.

    The integer form the selection argmax runs over — and the exact
    integers the engines embed (``wl_gp_q``) so the in-scan re-selection
    of a living channel (``phy.living.window_tables``) reproduces the
    host pass bitwise when the channel is static.
    """
    return np.rint(expected_goodput(per_r, table) * GP_SCALE
                   ).astype(np.int32)


def select_rates(per_r: np.ndarray, table=DEFAULT_RATE_TABLE) -> np.ndarray:
    """[W, W] adaptive per-link entry: fastest rate worth keeping.

    The expected-goodput argmax per link (ties break toward the faster
    entry), over the quantized integer goodput of ``goodput_q`` — see
    there for why integers.  In the physical regime — PER monotone in
    robustness, so goodput is unimodal across the table — this is
    exactly the fastest-first walk that stops at the first rate whose
    expected retransmissions no longer justify abandoning ("engineer
    the channel and adapt to it"); the argmax form also handles the
    degenerate saturated-PER links (every rate ~dead) where the walk's
    local comparison is uninformative.
    """
    # np.argmax returns the first maximum: equal goodputs pick the
    # faster entry
    return np.argmax(goodput_q(per_r, table), axis=0).astype(np.int32)


def oracle_fixed_rate(per_r: np.ndarray, used: np.ndarray,
                      table=DEFAULT_RATE_TABLE) -> int:
    """Best single fixed rate: max total expected goodput over used links."""
    gp = expected_goodput(per_r, table)
    totals = np.where(used[None], gp, 0.0).sum(axis=(1, 2))
    return int(np.argmax(totals))


def pack_link_state(topo: Topology, phy: PhyParams, tt, phy_spec,
                    b_dst: np.ndarray, b_depth: np.ndarray,
                    b_epb: np.ndarray, rx0: int):
    """Shared host-side PHY packing for BOTH engines' ``pack()``.

    One implementation on purpose: the dual-engine invariant covers the
    two step *formulations*, not this plain-python preprocessing — a
    single helper cannot drift between them.  Mutates ``b_depth`` /
    ``b_epb`` in place (store-and-forward buffer deepening, rx epb
    zeroing) and returns ``(pli, phy_on, rx_hold)``.
    """
    n_wi = topo.n_wi
    pli = link_tables(topo, phy, phy_spec)
    phy_on = pli is not None
    n_mc = getattr(tt, "n_mc", 0)
    deep = max(phy.pkt_flits,
               int(tt.lens.max()) if getattr(tt, "lens", None) is not None
               else 0)
    rx_hold = bool(n_mc > 0 or phy_on)
    if rx_hold:
        # store-and-forward receivers: rx buffers hold a whole packet
        # (multicast livelock fix + the ARQ tail-CRC check)
        for w in range(n_wi):
            b_depth[rx0 + w] = max(int(b_depth[rx0 + w]), deep)
    if phy_on:
        # ARQ senders hold the whole packet for retransmission (cf. the
        # token MAC) and wireless link energy moves to the per-pair
        # counters (metrics), so the rx buffers' epb is zeroed
        wi_set = set(int(x) for x in topo.wi_switch)
        for b in range(rx0):
            if int(b_dst[b]) in wi_set:
                b_depth[b] = max(int(b_depth[b]), deep)
        for w in range(n_wi):
            b_epb[rx0 + w] = 0.0
    return pli, phy_on, rx_hold


def link_tables(topo: Topology, phy: PhyParams,
                spec: PhySweepSpec | None,
                table=DEFAULT_RATE_TABLE) -> PhyLinkInfo | None:
    """Build the padded per-(src WI, dst WI) PHY tables of one point.

    Returns ``None`` when the point has no lossy PHY (``spec`` is None)
    or no wireless medium (``topo.n_wi == 0`` — wireline fabrics run the
    exact pre-PHY program, the fig9 "wireline unaffected" guarantee).
    """
    n_wi = topo.n_wi
    if spec is None or n_wi == 0:
        return None
    snr = link_snr_db(topo, spec)
    packet_bits = phy.pkt_flits * phy.flit_bits
    per_r = rate_per_matrix(snr, packet_bits, table)          # [R, W, W]

    pol = spec.policy
    if pol == "adaptive":
        idx = select_rates(per_r, table)
    elif pol == "oracle":
        used = ~np.eye(n_wi, dtype=bool)
        idx = np.full((n_wi, n_wi),
                      oracle_fixed_rate(per_r, used, table), np.int32)
    elif pol.startswith("fixed:"):
        i = int(pol.split(":", 1)[1]) % len(table)
        idx = np.full((n_wi, n_wi), i, np.int32)
    else:
        raise ValueError(f"unknown PHY rate policy {pol!r}")

    R = len(table)
    rate_idx = np.zeros((WMAX, WMAX), np.int32)
    serv = np.ones((WMAX, WMAX), np.int32)
    perq = np.zeros((WMAX, WMAX), np.int32)
    per = np.zeros((WMAX, WMAX), np.float64)
    epb = np.zeros((WMAX, WMAX), np.float64)
    perq_r = np.zeros((R, WMAX, WMAX), np.int32)
    gp_q = np.zeros((R, WMAX, WMAX), np.int32)
    snr_pad = np.zeros((WMAX, WMAX), np.float32)
    ii, jj = np.meshgrid(np.arange(n_wi), np.arange(n_wi), indexing="ij")
    per_sel = per_r[idx, ii, jj]
    rate_idx[:n_wi, :n_wi] = idx
    serv_r = phy.wireless_flit_cycles * np.asarray(
        [e.serv_scale for e in table], np.int32)
    serv[:n_wi, :n_wi] = serv_r[idx]
    # quantize PER onto the 16-bit CRC-hash range; ceil so a nonzero PER
    # never rounds to "lossless"
    perq_r[:, :n_wi, :n_wi] = np.minimum(
        np.ceil(per_r * float(1 << PER_Q)), float((1 << PER_Q) - 1)
    ).astype(np.int32)
    perq[:n_wi, :n_wi] = perq_r[idx, ii, jj]
    per[:n_wi, :n_wi] = per_sel
    epb_r = phy.e_wireless_pj_bit * np.asarray(
        [e.epb_scale for e in table])
    epb[:n_wi, :n_wi] = epb_r[idx]
    gp_q[:, :n_wi, :n_wi] = goodput_q(per_r, table)
    snr_pad[:n_wi, :n_wi] = snr
    return PhyLinkInfo(spec=spec, table=tuple(table), n_wi=n_wi,
                       rate_idx=rate_idx, serv=serv, perq=perq, per=per,
                       epb=epb, snr_db=snr,
                       serv_r=serv_r, epb_r=epb_r,
                       gain_r=np.asarray([e.gain for e in table],
                                         np.float32),
                       gbps_r=np.asarray([e.gbps for e in table],
                                         np.float32),
                       perq_r=perq_r, gp_q=gp_q, snr_pad=snr_pad)
