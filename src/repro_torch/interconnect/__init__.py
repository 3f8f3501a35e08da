"""Collective traffic: HLO parsing, schedule costs and fabric pricing
(copies of the numpy parts of ``repro.interconnect``)."""
