"""Simulator core: host-side tables, the cycle step, drivers, metrics, sweeps."""
