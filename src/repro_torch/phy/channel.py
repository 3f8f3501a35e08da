"""Deterministic per-(src WI, dst WI) link-quality model.

In-package mm-wave links are short but far from uniform: the sealed
package is a reverberant cavity whose path loss grows slowly with
distance but varies link to link with the die stack-up and the position
of the transceivers (Timoneda et al., *Channel Characterization for
Chip-scale Wireless Communications within Computing Packages*, 2018).
We model exactly the part that matters to a rate-adaptive MAC:

    SNR_db(i, j) = link_budget_db
                   - pl_exp * 10 * log10(max(d_ij, d0) / d0)
                   - shadow_db(i, j)

- ``d_ij`` is the Euclidean distance between the WIs' switch positions
  (``Topology.pos_mm``) — the *placement-dependent* term;
- ``shadow_db`` is a seeded, symmetric per-link normal draw — the
  *stack-up-dependent* term (the same physical link is equally shadowed
  in both directions; a WI talking to itself is never used);
- ``link_budget_db`` folds TX power, antenna gains and the noise floor
  into a single quality knob: sweeping it sweeps the whole package from
  "every link clean at the top rate" to "every link needs the robust
  rate", which is what ``benchmarks/fig9_lossy_channel.py`` does.

Everything is plain numpy on the host; the engines only ever see the
quantized per-link PER/service tables derived in ``phy.rates``.  This
module is therefore the executable reference the property tests pin:
BER must be monotone non-decreasing in distance and non-increasing in
the rate table's robustness gain.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class ChannelParams:
    """Propagation constants of the in-package channel.

    Defaults follow the chip-scale channel literature: a low path-loss
    exponent (the package is a closed, reverberant cavity, not free
    space) and a few dB of log-normal shadowing between links.
    """

    pl_exp: float = 0.8          # path-loss exponent (reverberant cavity)
    d0_mm: float = 1.0           # reference distance of the link budget
    sigma_shadow_db: float = 2.0  # per-link log-normal shadowing spread


@dataclasses.dataclass(frozen=True)
class PhySweepSpec:
    """Lossy-PHY configuration of one sweep point.

    Rides ``sweep.SweepPoint(phy_spec=...)`` exactly like
    ``MemSweepSpec`` rides ``mem=``.  Hashable (frozen) so points can be
    cached and compared.  ``policy`` selects the per-link rate:

    - ``"adaptive"``: the per-link selection pass of ``phy.rates``;
    - ``"fixed:<i>"``: rate-table entry ``i`` on every link (``i`` may
      be negative, python-style: ``"fixed:0"`` is the fastest entry,
      ``"fixed:-1"`` the most conservative);
    - ``"oracle"``: the single fixed rate maximizing total expected
      goodput over all links (``phy.rates.oracle_fixed_rate``).

    ``link_budget_db`` is the channel-quality knob (see module
    docstring); ``max_retx`` bounds ARQ attempts per packet — a packet
    failing CRC ``max_retx`` times is dropped and counted.

    ``drift_amp_db`` / ``drift_period`` / ``reselect`` make the channel
    a *living* one: a seeded per-link thermal-cycle walk
    degrades every link's SNR by up to ``drift_amp_db`` dB, updated once
    per ``core.chunked.CHUNK_CYCLES`` scan window and interpolated
    between knots ``drift_period`` windows apart (``phy.living``).
    ``reselect`` moves rate selection into the scan: at every window
    boundary each link re-picks its 16/8/4 Gbps entry from the current
    expected-goodput estimate.  With ``drift_amp_db == 0`` and
    ``reselect`` off the point runs the exact one-shot static program.
    """

    link_budget_db: float = 18.0
    policy: str = "adaptive"
    max_retx: int = 4
    seed: int = 0
    channel: ChannelParams = ChannelParams()
    drift_amp_db: float = 0.0    # peak SNR degradation of the aging walk
    drift_period: int = 8        # windows between drift knots
    reselect: bool = False       # in-scan per-window rate re-selection


def spec_is_living(spec: "PhySweepSpec | None") -> bool:
    """True iff the point needs the in-scan dynamic-channel path."""
    return spec is not None and (spec.drift_amp_db > 0.0 or spec.reselect)


def link_distances(topo: Topology) -> np.ndarray:
    """[W, W] Euclidean mm distance between WI switch positions."""
    p = topo.pos_mm[topo.wi_switch]                   # [W, 2]
    d = p[:, None, :] - p[None, :, :]
    return np.sqrt((d * d).sum(axis=-1))


def shadowing_db(seed: int, n_wi: int, sigma_db: float) -> np.ndarray:
    """[W, W] symmetric seeded shadowing draw (zero diagonal).

    One normal draw per unordered link, mirrored: the physical channel
    between two WIs is reciprocal, so both directions see the same
    shadowing.  Deterministic in (seed, n_wi, sigma).
    """
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(0x5EEDC4A7))
    raw = rng.normal(0.0, sigma_db, (n_wi, n_wi))
    sym = np.triu(raw, 1)
    sym = sym + sym.T
    return sym


def link_snr_db(topo: Topology, spec: PhySweepSpec) -> np.ndarray:
    """[W, W] per-link SNR in dB (diagonal unused, set to the budget)."""
    ch = spec.channel
    d = np.maximum(link_distances(topo), ch.d0_mm)
    pl = ch.pl_exp * 10.0 * np.log10(d / ch.d0_mm)
    return spec.link_budget_db - pl - shadowing_db(
        spec.seed, topo.n_wi, ch.sigma_shadow_db)


def ber_from_snr(snr_db: np.ndarray, gain: float) -> np.ndarray:
    """BER of non-coherent OOK at linear SNR * processing gain.

    ``BER = 0.5 * exp(-gamma / 2)`` — the standard envelope-detection
    OOK bound, matching the paper's 60 GHz OOK transceiver [6].  Slower
    rate-table entries integrate longer per bit: ``gain`` multiplies
    the effective SNR (R_max / R), which is what makes them robust.
    """
    gamma = np.power(10.0, np.asarray(snr_db, np.float64) / 10.0) * gain
    return 0.5 * np.exp(-gamma / 2.0)


def per_packet(ber: np.ndarray, packet_bits: int) -> np.ndarray:
    """Packet error rate of a ``packet_bits`` packet under i.i.d. BER."""
    return -np.expm1(packet_bits * np.log1p(-np.minimum(ber, 0.999999)))
