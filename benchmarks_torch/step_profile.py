"""Where the port's cycle step spends its time on the card.

    python3 benchmarks_torch/step_profile.py [--cycles 1024]
        [--mem | --trace | --phy [--living]] [--engine gather|ref]

Packs one batch of lanes at paper size, as ``run_sweep_batched`` does:

- by default the fig2 grid (substrate, interposer and wireless 4C4M, load
  1.0, p_mem 0.2): three lanes of the open-loop program;
- ``--mem``: fig8's 32 points (``tests/torch_fixtures/fig8_reference.json``'s
  cases: closed-loop memory at five loads, two windows, three fabrics,
  and canneal closed-loop), the ``mem_on`` program;
- ``--trace``: fig7's gemma-7b one-shot trace on the wireless fabric (one
  lane, multicast groups), the multicast program;
- ``--phy``: fig9's quality grid on the wireless fabric
  (``tests/torch_fixtures/fig9_reference.json``'s cases: six link budgets
  x three rate policies, 18 lanes), the lossy-PHY (``phy_on``) program;
- ``--phy --living``: fig9's drift sweep's online arm at 2, 4 and 6 dB
  (three lanes), the living program with drift and re-selection;

With ``--engine ref`` it profiles the mode's first point alone (one
lane) through the scatter engine (``core/simulator_ref.py``) and, beside
it in the same process, through the gather engine as a batch of one.

It reports, per engine profiled:

- host ms per simulated cycle of the eager chunked driver over
  ``--cycles`` cycles (wall clock ending in ``torch.cuda.synchronize()``);
- from a ``torch.profiler`` trace of 128 cycles: CUDA kernels launched
  per cycle, device-busy us per cycle (the sum of kernel durations) and
  the device's idle share of the traced window, and the kernels with the
  most device time.

Needs a CUDA device; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=1024)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--mem", action="store_true")
    mode.add_argument("--trace", action="store_true")
    mode.add_argument("--phy", action="store_true")
    ap.add_argument("--living", action="store_true",
                    help="with --phy: the drift sweep's online lanes")
    ap.add_argument("--engine", default="gather", choices=("gather", "ref"),
                    help="ref: the scatter engine beside the gather one, "
                    "on the mode's first point")
    args = ap.parse_args()
    if args.living and not args.phy:
        ap.error("--living needs --phy")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.core import simulator, sweep
    from repro_torch.core.constants import Fabric, SimParams
    from benchmarks_torch import figures

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.mem:
        fx = figures.fixture("fig8_reference.json")
        sim = SimParams(**fx["sim"])
        pts = [figures.fig8_point(p["case"], sim) for p in fx["points"]]
    elif args.phy:
        fx = figures.fixture("fig9_reference.json")
        sim = SimParams(**fx["sim"])
        if args.living:
            pts = [figures.fig9_drift_point(p["case"], sim, fx["load"],
                                            fx["p_mem"], fx["drift_budget_db"])
                   for p in fx["drift"] if p["case"]["arm"] == "online"
                   and p["case"]["amp_db"] > 0]
        else:
            pts = [figures.fig9_quality_point(p["case"], sim, fx["load"],
                                              fx["p_mem"])
                   for p in fx["quality"] if p["case"]["fabric"] == 2]
    elif args.trace:
        sim = SimParams(cycles=96_000, warmup=0)
        (name, tr), = figures.fig7_traces(("gemma-7b-oneshot",))
        pts = [figures.fig7_point(name, tr, "WIRELESS", sim)]
    else:
        sim = SimParams(cycles=10_000, warmup=1_000)
        pts = [sweep.SweepPoint(4, 4, f, load=1.0, p_mem=0.2, sim=sim)
               for f in (Fabric.SUBSTRATE, Fabric.INTERPOSER,
                         Fabric.WIRELESS)]
    mode = "mem" if args.mem else "trace" if args.trace \
        else ("living" if args.living else "phy") if args.phy else "open"
    if args.engine == "ref":
        from repro_torch.core import simulator_ref
        p = pts[0]
        topo, rt, tt, _ = sweep._build_point(p)
        ps = simulator.pack(topo, rt, tt, p.phy, p.sim, phy_spec=p.phy_spec,
                            device="cuda")
        pr = simulator_ref.pack(topo, rt, tt, p.phy, p.sim,
                                phy_spec=p.phy_spec, device="cuda")
        profile(lambda c: simulator.run_batch([ps], cycles=c), args.cycles,
                dict(mode=mode, engine="gather", **ps.flags(),
                     mc_on=ps.mc_on, lanes=1, B=ps.B, power=smi))
        profile(lambda c: simulator_ref.run(pr, cycles=c), args.cycles,
                dict(mode=mode, engine="ref", **pr.flags(), lanes=1, B=pr.B,
                     power=smi))
        return 0
    built = [sweep._build_point(p) for p in pts]
    dims = [simulator.pack_dims(topo, tt) for topo, _, tt, _ in built]
    floors = {k: max(d[k] for d in dims) for k in sweep.HARMONIZED_DIMS}
    pss = [simulator.pack(topo, rt, tt, p.phy, p.sim, floors=floors,
                          phy_spec=p.phy_spec, device="cuda")
           for p, (topo, rt, tt, _) in zip(pts, built)]
    assert len({ps.shape_key() for ps in pss}) == 1, "one batch expected"
    profile(lambda c: simulator.run_batch(pss, cycles=c), args.cycles,
            dict(mode=mode, engine="gather", **pss[0].flags(),
                 mc_on=pss[0].mc_on, lanes=len(pss), B=pss[0].B, power=smi))
    return 0


def profile(run, cycles: int, rec: dict) -> None:
    """Time ``run(c)`` (``c`` cycles) over ``cycles`` after a warm-up, and
    trace 128 cycles of it; print ``rec`` with the numbers."""
    import torch
    run(128)                                          # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(cycles)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / cycles

    traced = 128
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run(traced)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    rec.update(
        timed_cycles=cycles, host_ms_per_cycle=host_ms,
        traced_cycles=traced,
        kernels_per_cycle=len(kernels) / traced if kernels else None,
        device_busy_us_per_cycle=busy_us / traced if kernels else None,
        traced_wall_us_per_cycle=wall_us / traced,
        device_idle_share=1 - busy_us / wall_us if kernels else None,
        top_kernels_us=[(n[:80], round(us, 1))
                        for n, us in by_name.most_common(8)])
    if not kernels:
        print("step_profile: the profiler saw no CUDA kernels; device time "
              "not measured", flush=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    sys.exit(main())
