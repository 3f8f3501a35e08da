"""Simulator speed on the card: the counterpart of ``benchmarks/simspeed.py``.

    python3 benchmarks_torch/simspeed.py

On the same fixed 8-point open-loop grid (wireless and interposer 4C4M at
loads 0.05, 0.2, 0.5 and 1.0, 2 000 cycles with 400 of warm-up) and the
same drain-heavy trace grid (one phase-barrier trace with multicasts on
the wireless and interposer fabrics, a 12 000-cycle budget) as the
reference script, prints its rows:

- ``simspeed,cycles_per_sec`` / ``us_per_cycle``: one wireless point
  (load 0.3) through ``simulator.pack`` + ``simulator.run``;
- ``seq_points_per_sec`` (a ``run_point`` loop) against
  ``batched_points_per_sec`` (``run_sweep_batched``, one lockstep batch),
  with ``simspeed.check,batched_equals_sequential``;
- ``mono_fixed_points_per_sec``: the grid's packed lanes through the
  monolithic driver beside the chunked one (``chunked_points_per_sec``),
  with ``simspeed.check,chunked_equals_mono_fixed`` (every state leaf);
- the drain grid through both drivers, with
  ``simspeed.check,chunked_equals_mono_drain`` (every state leaf), each
  lane's drain cycle, and ``speedup_chunked_vs_mono_drain`` (the
  reference fails under 1.2x, as here);
- ``ref_seq_points_per_sec``: the scatter engine
  (``core/simulator_ref.py``) on the grid's first two points, one point
  at a time as the reference runs it, with
  ``simspeed.check,scatter_equals_batched`` (its metrics against the
  batched run's);
- the speedups between them.

The reference's XLA host-device sharding has no counterpart (one card,
one lane dimension); every run is preceded by a short warm-up rather than
a compile.  Prints the rows and the card's name and power limit; writes
no file.  Needs a CUDA device.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID_LOADS = (0.05, 0.2, 0.5, 1.0)
REF_POINTS = 2          # the scatter engine is slow; points/s from two
WARM = 128              # warm-up cycles before each timed run


def emit(row: str) -> None:
    print(row, flush=True)


def _packed_lanes(pts, dev):
    """``run_sweep_batched``'s packing of one group: harmonized floors."""
    from repro_torch.core import simulator, sweep
    built = [sweep._build_point(p) for p in pts]
    dims = [simulator.pack_dims(topo, tt) for topo, _, tt, _ in built]
    floors = {k: max(d[k] for d in dims) for k in sweep.HARMONIZED_DIMS}
    return [simulator.pack(topo, rt, tt, p.phy, p.sim, floors=floors,
                           phy_spec=p.phy_spec, device=dev)
            for p, (topo, rt, tt, _) in zip(pts, built)]


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _same_states(a, b) -> bool:
    import torch
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("simspeed: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import simulator, simulator_ref, traffic
    from repro_torch.core.constants import DEFAULT_PHY, Fabric, SimParams
    from repro_torch.core.metrics import compute_metrics_batch
    from repro_torch.core.routing import compute_routing
    from repro_torch.core.sweep import SweepPoint, run_point, \
        run_sweep_batched
    from repro_torch.core.topology import build_xcym
    from repro_torch.workloads.trace import Trace, mcast, p2p, phase

    dev = torch.device("cuda")
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    sim = SimParams(cycles=2000, warmup=400)
    grid = [(fab, load) for fab in (Fabric.WIRELESS, Fabric.INTERPOSER)
            for load in GRID_LOADS]
    pts = [SweepPoint(4, 4, fab, load=load, sim=sim) for fab, load in grid]
    G = len(pts)

    # single-point cycle rate
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    rt = compute_routing(topo)
    tt = traffic.uniform_random(topo, 0.3, 0.2, sim.cycles, 64, seed=0)
    ps = simulator.pack(topo, rt, tt, DEFAULT_PHY, sim, device=dev)
    simulator.run(ps, cycles=WARM)
    _, dt = _timed(lambda: simulator.run(ps))
    emit(f"simspeed,cycles_per_sec,{sim.cycles / dt:.0f}")
    emit(f"simspeed,us_per_cycle,{dt / sim.cycles * 1e6:.1f}")

    # sequential (one batch of one per point) against batched
    run_point(4, 4, Fabric.WIRELESS, load=0.05,
              sim=SimParams(cycles=WARM, warmup=0), device=dev)
    ms_seq, t_seq = _timed(lambda: [
        run_point(4, 4, fab, load=load, sim=sim, device=dev)
        for fab, load in grid])
    ms_bat, t_bat = _timed(lambda: run_sweep_batched(pts, device=dev))
    same = all(a.pkts_delivered == b.pkts_delivered
               and a.flits_delivered == b.flits_delivered
               and a.throughput == b.throughput
               for a, b in zip(ms_seq, ms_bat))
    emit(f"simspeed,grid_points,{G}")
    emit(f"simspeed.check,batched_equals_sequential,{same}")
    if not same:
        raise SystemExit("simspeed: batched metrics diverged from sequential")
    emit(f"simspeed,seq_points_per_sec,{G / t_seq:.3f}")
    emit(f"simspeed,batched_points_per_sec,{G / t_bat:.3f}")

    # chunked against monolithic on the same packed lanes: the traffic
    # spans the whole budget, so this prices the driver alone
    pss = _packed_lanes(pts, dev)
    st_c, t_c = _timed(lambda: simulator.run_batch(pss))
    st_m, t_m = _timed(lambda: simulator.run_batch(pss, driver="monolithic"))
    same = _same_states(st_c, st_m)
    emit(f"simspeed.check,chunked_equals_mono_fixed,{same}")
    if not same:
        raise SystemExit("simspeed: chunked diverged from monolithic")
    emit(f"simspeed,chunked_points_per_sec,{G / t_c:.3f}")
    emit(f"simspeed,mono_fixed_points_per_sec,{G / t_m:.3f}")
    emit(f"simspeed,speedup_chunked_vs_mono_fixed,{t_m / t_c:.2f}")

    # drain-heavy trace grid: the early-exit win
    dsim = SimParams(cycles=12_000, warmup=0)
    dtrace = Trace("simspeed-drain", 8, [
        phase([mcast(0, (2, 3, 4, 5), 1024.0), p2p(1, 6, 512.0)],
              label="a"),
        phase([p2p(6, 1, 256.0), p2p(3, 0, 256.0)], label="b"),
        phase([mcast(4, (0, 1, 2), 512.0)], label="c"),
    ])
    dpts = [SweepPoint(4, 4, fab, trace=dtrace, sim=dsim,
                       name=f"drain/{fab.name.lower()}")
            for fab in (Fabric.WIRELESS, Fabric.INTERPOSER)]
    # (the wireless lane carries multicast groups, the interposer lane
    # their unicast expansion: two step programs, two batches, as in
    # run_sweep_batched)
    dpss = _packed_lanes(dpts, dev)
    groups: dict = {}
    for i, p in enumerate(dpss):
        groups.setdefault(p.shape_key(), []).append(i)

    def run_groups(driver):
        return [simulator.run_batch([dpss[i] for i in ix], driver=driver)
                for ix in groups.values()]

    sd_c, t_dc = _timed(lambda: run_groups("chunked"))
    sd_m, t_dm = _timed(lambda: run_groups("monolithic"))
    # the monolithic oracle runs every cycle: its drain_cycle is the budget
    same = all(_same_states(c._replace(drain_cycle=m.drain_cycle), m)
               for c, m in zip(sd_c, sd_m))
    emit(f"simspeed.check,chunked_equals_mono_drain,{same}")
    if not same:
        raise SystemExit("simspeed: drain-grid chunked != monolithic")
    ms_dr = [m for ix, st in zip(groups.values(), sd_c)
             for m in compute_metrics_batch(
                 [dpss[i] for i in ix], st, [dpts[i].name for i in ix],
                 [0.0] * len(ix))]
    for m in ms_dr:
        if not m.trace_done:
            raise SystemExit(f"simspeed: drain trace incomplete on {m.name}")
        emit(f"simspeed.drain,{m.name},{m.drain_cycle},{m.cycles_run}")
    Gd = len(dpts)
    emit(f"simspeed,drain_points_per_sec,{Gd / t_dc:.3f}")
    emit(f"simspeed,mono_drain_points_per_sec,{Gd / t_dm:.3f}")
    emit(f"simspeed,speedup_chunked_vs_mono_drain,{t_dm / t_dc:.2f}")
    if t_dm / t_dc < 1.2:
        raise SystemExit(f"simspeed: early-exit win {t_dm / t_dc:.2f}x "
                         "under 1.2x")

    # the scatter engine, one point at a time
    ref = []
    for fab, load in grid[:REF_POINTS]:
        topo_r = build_xcym(4, 4, fab)
        rt_r = compute_routing(topo_r)
        tt_r = traffic.uniform_random(topo_r, load, 0.2, sim.cycles, 64,
                                      seed=sim.seed)
        ref.append((simulator_ref.pack(topo_r, rt_r, tt_r, DEFAULT_PHY, sim,
                                       device=dev), tt_r.offered_load))
    simulator_ref.run(ref[0][0], cycles=WARM)
    sts, t_ref = _timed(lambda: [simulator_ref.run(r) for r, _ in ref])
    t_ref /= REF_POINTS
    ms_ref = [compute_metrics_batch([r], type(s)(*(x[None] for x in s)),
                                    [m.name], [load])[0]
              for (r, load), s, m in zip(ref, sts, ms_bat)]
    same = all(a.pkts_delivered == b.pkts_delivered
               and a.flits_delivered == b.flits_delivered
               and a.throughput == b.throughput
               and a.avg_pkt_energy_pj == b.avg_pkt_energy_pj
               for a, b in zip(ms_ref, ms_bat))
    emit(f"simspeed.check,scatter_equals_batched,{same}")
    if not same:
        raise SystemExit("simspeed: the scatter engine diverged")
    emit(f"simspeed,ref_seq_points_per_sec,{1 / t_ref:.3f}")
    emit(f"simspeed,speedup_batched_vs_seq,{t_seq / t_bat:.2f}")
    emit(f"simspeed,speedup_batched_vs_ref_seq,{t_ref * G / t_bat:.2f}")
    emit(f"simspeed,speedup_seq_vs_ref_seq,{t_ref * G / t_seq:.2f}")
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
