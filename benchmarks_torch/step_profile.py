"""Where the port's cycle step spends its time on the card.

    python3 benchmarks_torch/step_profile.py [--cycles 1024]

Packs the fig2 grid at paper size (substrate, interposer and wireless
4C4M, load 1.0, p_mem 0.2) as three lanes, as ``run_sweep_batched`` does,
and reports:

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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import simulator, sweep
    from repro_torch.core.constants import Fabric, SimParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    sim = SimParams(cycles=10_000, warmup=1_000)
    pts = [sweep.SweepPoint(4, 4, f, load=1.0, p_mem=0.2, sim=sim)
           for f in (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)]
    built = [sweep._build_point(p) for p in pts]
    dims = [simulator.pack_dims(topo, tt) for topo, _, tt, _ in built]
    floors = {k: max(d[k] for d in dims) for k in sweep.HARMONIZED_DIMS}
    pss = [simulator.pack(topo, rt, tt, p.phy, p.sim, floors=floors,
                          device="cuda")
           for p, (topo, rt, tt, _) in zip(pts, built)]

    simulator.run_batch(pss, cycles=128)              # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    simulator.run_batch(pss, cycles=args.cycles)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / args.cycles

    traced = 128
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        simulator.run_batch(pss, cycles=traced)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    rec = dict(
        lanes=len(pss), B=pss[0].B, timed_cycles=args.cycles,
        host_ms_per_cycle=host_ms,
        traced_cycles=traced,
        kernels_per_cycle=len(kernels) / traced if kernels else None,
        device_busy_us_per_cycle=busy_us / traced if kernels else None,
        traced_wall_us_per_cycle=wall_us / traced,
        device_idle_share=1 - busy_us / wall_us if kernels else None,
        top_kernels_us=[(n[:80], round(us, 1))
                        for n, us in by_name.most_common(8)],
        power=smi)
    if not kernels:
        print("step_profile: the profiler saw no CUDA kernels; device time "
              "not measured", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
