"""Lossy-channel PHY of the in-package 60 GHz medium (port of
``repro.phy``).

- ``phy.channel``: the per-(src WI, dst WI) link-quality model (path loss
  plus seeded shadowing gives an SNR, the SNR a BER per rate entry);
- ``phy.rates``: the rate table, the static per-link rate selection and
  ``pack_link_state``, which ``simulator.pack`` calls;
- ``phy.retx``: the counter-based CRC hash the step draws per (seed,
  packet, attempt) against the link's PER threshold, and the host
  reference of per-packet attempts and drops;
- ``phy.living``: the in-scan living channel, a seeded per-link SNR drift
  walk and per-window rate re-selection, applied at window boundaries.
"""
from repro_torch.phy.channel import (ChannelParams, PhySweepSpec,
                                     link_distances, link_snr_db,
                                     shadowing_db, spec_is_living)
from repro_torch.phy.living import drift_unit, make_window_fn, window_tables
from repro_torch.phy.rates import (DEFAULT_RATE_TABLE, GP_SCALE, RateEntry,
                                   goodput_q, link_tables,
                                   oracle_fixed_rate, select_rates,
                                   PhyLinkInfo)
from repro_torch.phy.retx import crc_fail, crc_hash, reference_attempts

__all__ = [
    "ChannelParams", "PhySweepSpec", "link_distances", "link_snr_db",
    "shadowing_db", "spec_is_living", "DEFAULT_RATE_TABLE", "GP_SCALE",
    "RateEntry", "PhyLinkInfo", "goodput_q", "link_tables",
    "oracle_fixed_rate", "select_rates", "drift_unit", "make_window_fn",
    "window_tables", "crc_fail", "crc_hash", "reference_attempts",
]
