"""Write ``fig2_reference.json``: the JAX package's fig2 grid at paper size.

Substrate, interposer and wireless 4C4M at load 1.0, p_mem 0.2, 10 000
cycles with 1 000 of warm-up (paper §IV, ``benchmarks/fig2_uniform.py``),
in one ``run_sweep_batched`` call on the CPU.  ``chip_smoke.py`` holds the
port's run of the same grid against this file.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fig2_reference.py
"""
import json
import pathlib

from repro.core.constants import Fabric, SimParams
from repro.core.sweep import SweepPoint, run_sweep_batched

OUT = pathlib.Path(__file__).parent / "fig2_reference.json"
SIM = SimParams(cycles=10_000, warmup=1_000, seed=0)
FABRICS = (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)
INT_FIELDS = ("pkts_delivered", "flits_delivered", "flits_injected",
              "cycles_run", "drain_cycle")
FLOAT_FIELDS = ("offered_load", "throughput", "bw_gbps_core",
                "avg_pkt_latency", "avg_pkt_energy_pj", "energy_pj_bit")


def main() -> None:
    ms = run_sweep_batched([SweepPoint(4, 4, f, load=1.0, p_mem=0.2, sim=SIM)
                            for f in FABRICS])
    rec = {"sim": {"cycles": SIM.cycles, "warmup": SIM.warmup,
                   "seed": SIM.seed},
           "points": {}}
    for f, m in zip(FABRICS, ms):
        r = {k: int(getattr(m, k)) for k in INT_FIELDS}
        r.update({k: float(getattr(m, k)) for k in FLOAT_FIELDS})
        r["energy_breakdown"] = {k: float(v)
                                 for k, v in m.energy_breakdown.items()}
        rec["points"][f.name] = {"case": dict(n_chips=4, n_mem=4,
                                              fabric=int(f), load=1.0,
                                              p_mem=0.2),
                                 "metrics": r}
    OUT.write_text(json.dumps(rec, indent=2, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
