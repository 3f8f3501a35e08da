"""High-level experiment drivers for the paper's evaluations (§IV.B-D);
port of ``repro.core.sweep``.

- ``run_point``: simulate one (system, fabric, traffic) point (a batch of
  one).
- ``run_sweep_batched``: simulate a grid of points in as few lockstep
  batches as possible.  Points are grouped by the number of traffic
  sources N; within a group the pack dims are harmonized (every point
  packed with the group's max dims as floors — padding is semantically
  inert) so that, e.g., the three fabrics of one system size share one
  batch.  Cycle budgets and warm-ups are per-lane data.

Results equal ``[run_point(...) for each point]`` exactly.  The reference's
``devices`` argument (``pmap`` sharding over host devices) has no
counterpart: one card, one lane dimension.  Every entry point takes
``device`` (``None`` = CUDA; the CPU only when asked for).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Sequence

from repro_torch import device as _device
from repro_torch.core import simulator, traffic
from repro_torch.core.constants import (DEFAULT_PHY, Fabric, PhyParams,
                                        SimParams)
from repro_torch.core.metrics import Metrics, compute_metrics_batch
from repro_torch.core.routing import compute_routing
from repro_torch.core.topology import build_xcym

HARMONIZED_DIMS = ("B", "S", "R", "K", "CS", "CR", "M", "P", "Y", "BK")


@functools.lru_cache(maxsize=64)
def _cached_system(n_chips: int, n_mem: int, fabric: Fabric, phy: PhyParams,
                   wireless_weight: float):
    topo = build_xcym(n_chips, n_mem, fabric, phy)
    rt = compute_routing(topo, wireless_weight=wireless_weight)
    return topo, rt


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One evaluation point of a figure grid (run_point's argument list).

    Fields as in ``repro.core.sweep.SweepPoint``.  ``trace``, ``mem``,
    ``closed_loop`` and ``phy_spec`` points raise ``NotImplementedError``
    in the port (ROADMAP A5-A7).
    """

    n_chips: int
    n_mem: int
    fabric: Fabric
    load: float = 0.0
    p_mem: float = 0.2
    phy: PhyParams = DEFAULT_PHY
    sim: SimParams = dataclasses.field(default_factory=SimParams)
    app: str | None = None
    trace: object | None = None
    mem: object | None = None
    closed_loop: bool = False
    dram: object | None = None
    phy_spec: object | None = None
    wireless_weight: float = 3.0
    name: str | None = None


def _build_point(p: SweepPoint):
    """Host-side construction: topology, routing, traffic table, label."""
    topo, rt = _cached_system(p.n_chips, p.n_mem, p.fabric, p.phy,
                              p.wireless_weight)
    if p.trace is not None:
        tt = traffic.from_trace(topo, p.trace, p.phy.pkt_flits,
                                p.phy.flit_bits, dram=p.dram)
    elif p.mem is not None:
        raise NotImplementedError("closed-loop memory: ROADMAP A6")
    elif p.app is None:
        tt = traffic.uniform_random(topo, p.load, p.p_mem, p.sim.cycles,
                                    p.phy.pkt_flits, seed=p.sim.seed)
    else:
        tt = traffic.application(topo, traffic.APP_MODELS[p.app],
                                 p.sim.cycles, p.phy.pkt_flits,
                                 seed=p.sim.seed, load_scale=p.load,
                                 closed_loop=p.closed_loop, dram=p.dram)
    label = p.name or f"{topo.name}/load={p.load}/p_mem={p.p_mem}" \
        + (f"/{p.app}" if p.app else "") \
        + ("/closed" if p.closed_loop else "")
    return topo, rt, tt, label


def run_sweep_batched(points: Sequence[SweepPoint],
                      cycles: int | None = None,
                      device=None) -> list[Metrics]:
    """Simulate a grid of points in as few lockstep batches as possible.

    Returns one ``Metrics`` per point, in input order, equal to
    ``[run_point(...) for each point]``.
    """
    dev = _device.resolve(device)
    built = [_build_point(p) for p in points]
    natural = [simulator.pack_dims(topo, tt) for topo, _, tt, _ in built]

    # group by N sources; harmonize pack dims within a group
    groups: dict[tuple, list[int]] = {}
    for i, (_, _, tt, _) in enumerate(built):
        groups.setdefault((tt.n_sources,), []).append(i)

    results: list[Metrics | None] = [None] * len(points)
    for idxs in groups.values():
        floors = {d: max(natural[i][d] for i in idxs)
                  for d in HARMONIZED_DIMS}
        packed = {}
        for i in idxs:
            topo, rt, tt, _ = built[i]
            packed[i] = simulator.pack(topo, rt, tt, points[i].phy,
                                       points[i].sim, floors=floors,
                                       phy_spec=points[i].phy_spec,
                                       device=dev)
        # harmonized dims should unify shapes; split defensively by shape
        by_shape: dict[tuple, list[int]] = {}
        for i in idxs:
            by_shape.setdefault(packed[i].shape_key(), []).append(i)
        for sub in by_shape.values():
            pss = [packed[i] for i in sub]
            st = simulator.run_batch(pss, cycles=cycles)
            ms = compute_metrics_batch(
                pss, st, [built[i][3] for i in sub],
                [built[i][2].offered_load for i in sub], cycles=cycles)
            for i, m in zip(sub, ms):
                results[i] = m
    return results  # type: ignore[return-value]


def run_point(
    n_chips: int,
    n_mem: int,
    fabric: Fabric,
    load: float,
    p_mem: float = 0.2,
    phy: PhyParams = DEFAULT_PHY,
    sim: SimParams = SimParams(),
    app: str | None = None,
    mem: object | None = None,
    closed_loop: bool = False,
    dram: object | None = None,
    phy_spec: object | None = None,
    wireless_weight: float = 3.0,
    name: str | None = None,
    device=None,
) -> Metrics:
    """Simulate one (system, fabric, traffic) point and return §IV metrics."""
    return run_sweep_batched([SweepPoint(
        n_chips=n_chips, n_mem=n_mem, fabric=fabric, load=load, p_mem=p_mem,
        phy=phy, sim=sim, app=app, mem=mem, closed_loop=closed_loop,
        dram=dram, phy_spec=phy_spec, wireless_weight=wireless_weight,
        name=name)], device=device)[0]


def saturation_bandwidth(n_chips: int, n_mem: int, fabric: Fabric,
                         p_mem: float = 0.2, **kw) -> Metrics:
    """Peak achievable bandwidth: drive at max load, report delivered."""
    return run_point(n_chips, n_mem, fabric, load=1.0, p_mem=p_mem, **kw)


def latency_sweep(n_chips: int, n_mem: int, fabric: Fabric,
                  loads: Iterable[float], p_mem: float = 0.2,
                  device=None, **kw) -> list[Metrics]:
    """Latency-vs-load curve for one fabric, batched into one launch."""
    return run_sweep_batched([
        SweepPoint(n_chips=n_chips, n_mem=n_mem, fabric=fabric, load=l,
                   p_mem=p_mem, **kw) for l in loads], device=device)
