"""Write ``quickstart_reference.json``: the JAX package's
``examples/quickstart.py`` points (4C4M in the three fabrics, uniform
random traffic with p_mem 0.2, at load 1.0 and at load 0.05), each run
with ``run_point`` as the script runs it, at the script's budget (4 000
cycles with 800 of warm-up, for ``chip_smoke.py``'s run of
``examples/torch_quickstart.py``) and at the short budget of the CPU
test (``tests/test_torch_examples.py``).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_quickstart_reference.py

Takes ~3-4 minutes on the CPU.
"""
import json
import pathlib

from repro.core.constants import Fabric, SimParams
from repro.core.sweep import run_point

OUT = pathlib.Path(__file__).parent / "quickstart_reference.json"
BUDGETS = {"script": SimParams(cycles=4000, warmup=800),
           "short": SimParams(cycles=300, warmup=60)}
FABRICS = (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)
LOADS = (1.0, 0.05)
INT_FIELDS = ("pkts_delivered", "flits_delivered", "flits_injected",
              "cycles_run", "drain_cycle")
FLOAT_FIELDS = ("offered_load", "throughput", "bw_gbps_core",
                "avg_pkt_latency", "avg_pkt_energy_pj", "energy_pj_bit")


def main() -> None:
    rec = {}
    for name, sim in BUDGETS.items():
        points = []
        for f in FABRICS:
            for load in LOADS:
                m = run_point(4, 4, f, load=load, p_mem=0.2, sim=sim)
                r = {k: int(getattr(m, k)) for k in INT_FIELDS}
                r.update({k: float(getattr(m, k)) for k in FLOAT_FIELDS})
                points.append({"fabric": f.name, "load": load,
                               "metrics": r})
                print(name, f.name, load, r, flush=True)
        rec[name] = {"sim": {"cycles": sim.cycles, "warmup": sim.warmup,
                             "seed": sim.seed}, "points": points}
    OUT.write_text(json.dumps(rec, indent=2, sort_keys=True) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
