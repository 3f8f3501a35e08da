"""Wireless PHY tables (numpy copies of ``repro.phy.channel``/``rates``).

``pack`` calls ``rates.pack_link_state``; the lossy-channel ARQ path of
the cycle step is not ported yet.
"""
