"""Write ``fig8_reference.json``: the JAX package's fig8 grid.

The grid of ``benchmarks/fig8_memory.py`` without ``FIG8_SMOKE``: 4C4M on
the three fabrics, closed-loop memory traffic at loads 0.05, 0.15, 0.3,
0.6 and 1.0 with ``max_outstanding`` windows 4 and 16, plus canneal
closed-loop on the wireless and interposer fabrics; 32 points, 2 000
cycles with 500 of warm-up (fig8's 6 000 cut so that ``chip_smoke.py``
stays within its time limit with fig9 and the hybrid and MoE phases), in
one ``run_sweep_batched`` call on the CPU.  Each point is stored with its case and every ``Metrics`` field;
``chip_smoke.py`` rebuilds the points from the cases and holds the port's
run against the metrics (integers exact, floats rel 1e-6).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fig8_reference.py
"""
import dataclasses
import json
import pathlib

from repro.core.constants import Fabric, SimParams
from repro.core.sweep import SweepPoint, run_sweep_batched
from repro.memory import DramTimingParams, MemSweepSpec

OUT = pathlib.Path(__file__).parent / "fig8_reference.json"
SIM = SimParams(cycles=2_000, warmup=500, seed=0)
LOADS = (0.05, 0.15, 0.3, 0.6, 1.0)
WINDOWS = (4, 16)
FABRICS = (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)


def cases() -> list[dict]:
    """fig8's points, in its order: windows x loads x fabrics, canneal."""
    out = [dict(fabric=int(f), load=ld, max_outstanding=mo)
           for mo in WINDOWS for ld in LOADS for f in FABRICS]
    out += [dict(fabric=int(f), load=1.0, app="canneal")
            for f in (Fabric.WIRELESS, Fabric.INTERPOSER)]
    return out


def point(case: dict) -> SweepPoint:
    if "app" in case:
        return SweepPoint(4, 4, Fabric(case["fabric"]), load=case["load"],
                          app=case["app"], closed_loop=True, sim=SIM)
    dram = DramTimingParams(max_outstanding=case["max_outstanding"])
    return SweepPoint(4, 4, Fabric(case["fabric"]), sim=SIM,
                      mem=MemSweepSpec(load=case["load"], dram=dram))


def main() -> None:
    cs = cases()
    ms = run_sweep_batched([point(c) for c in cs])
    rec = {"sim": {"cycles": SIM.cycles, "warmup": SIM.warmup,
                   "seed": SIM.seed},
           "points": [{"case": c, "metrics": dataclasses.asdict(m)}
                      for c, m in zip(cs, ms)]}
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}: {len(cs)} points")


if __name__ == "__main__":
    main()
