"""Quickstart on the PyTorch port: the paper's experiment in a few lines.

Builds the 4C4M multichip system in all three fabrics, runs the
cycle-accurate simulator under uniform random traffic (``p_mem`` 0.2) at
saturation (load 1.0) and at low load (0.05), and prints the paper's three
metrics (bandwidth / latency / energy) side by side, as
``examples/quickstart.py`` does with the JAX package.

The six points run as one ``run_sweep_batched`` call, where the JAX script
calls ``run_point`` six times: a batched sweep's metrics equal
``run_point``'s point for point (``tests/test_torch_sweep.py`` holds
that), and on the card one call runs the six lanes in lockstep instead of
six host-bound runs of 4 000 cycles each.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.core.constants import Fabric, SimParams
from repro_torch.core.sweep import SweepPoint, run_sweep_batched

SIM = SimParams(cycles=4000, warmup=800)
FABRICS = (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)
LOADS = (1.0, 0.05)                 # saturation, low load


def rows(sim: SimParams = SIM, device=None) -> list:
    """``(fabric, saturation metrics, low-load metrics)`` per fabric."""
    pts = [SweepPoint(4, 4, f, load=load, p_mem=0.2, sim=sim)
           for f in FABRICS for load in LOADS]
    ms = run_sweep_batched(pts, device=device)
    return [(f, ms[2 * i], ms[2 * i + 1]) for i, f in enumerate(FABRICS)]


def table(got: list) -> str:
    lines = [f"{'fabric':12s} {'bw (Gbps/core)':>15s} {'latency (cyc)':>14s} "
             f"{'energy (pJ/pkt)':>16s}"]
    for fabric, sat, low in got:
        lines.append(f"{fabric.name:12s} {sat.bw_gbps_core:15.2f} "
                     f"{low.avg_pkt_latency:14.1f} "
                     f"{sat.avg_pkt_energy_pj:16.0f}")
    return "\n".join(lines)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    got = rows(SIM, args.device)
    print(table(got))
    print("\nwireless wins all three axes -> the paper's Fig. 2/3 headline.")
    return got


if __name__ == "__main__":
    main()
