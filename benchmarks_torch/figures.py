"""The paper's figures built by the port: fig2-fig6 and the ablations,
fig7's ML traces, fig8's closed-loop memory grid and fig9's lossy
channel.

fig2-fig6 and the ablations are the grids of ``benchmarks/fig2_uniform.py``
to ``benchmarks/ablations.py``, with those scripts' constants (``LOADS``,
``OFF``, ``P_MEMS``, the apps of ``APP_MODELS``), their ``run_sweep_batched``
calls in their order, the ablations' WI-density points through the raw
API, and each script's CSV rows, ``*.check`` truth values and derived
gains and reductions (``paper_report``).  ``benchmarks_torch/paper_figs.py``
runs them at paper size, ``chip_smoke.py`` phase 21 at its cut, both held
against ``tests/torch_fixtures/paper_figs_reference.json``.

The points of ``benchmarks/fig7_ml_traces.py``,
``benchmarks/fig8_memory.py`` and ``benchmarks/fig9_lossy_channel.py`` at
paper size, rebuilt from the cases of the fixtures the JAX package writes
(``tests/torch_fixtures/make_fig7_reference.py``,
``make_fig8_reference.py``, ``make_fig9_reference.py``), so that the port
runs exactly the grid its reference numbers come from, and fig9's hard
checks as that script states them.  The compiled psum
trace is parsed from the fixture's HLO text (the card's machine has no
JAX).  Used by ``chip_smoke.py`` and ``step_profile.py``; needs ``src/``
on ``sys.path``.
"""
from __future__ import annotations

import json
import pathlib

FIXTURES = pathlib.Path(__file__).resolve().parents[1] / "tests" \
    / "torch_fixtures"
N_CHIPS, N_MEM, N_DEV = 4, 4, 16
TARGET_PKTS = 120
# (name, model, schedule); model None = the compiled psum trace
FIG7_RECIPES = (("gemma-7b", "gemma-7b", "auto"),
                ("mixtral-8x22b", "mixtral-8x22b", "auto"),
                ("llama3-405b", "llama3-405b", "auto"),
                ("gemma-7b-oneshot", "gemma-7b", "oneshot"),
                ("compiled", None, "auto"))
FIG7_FABRICS = ("WIRELESS", "INTERPOSER", "SUBSTRATE")


def fixture(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


def autoscale(tr, pkt_bytes: float = 256.0):
    """fig7's ``_autoscale``: ~TARGET_PKTS packets per emitted table."""
    total = tr.bytes_total()
    n_msgs = sum(len(p.messages) for p in tr.phases)
    want = max(TARGET_PKTS, n_msgs) * pkt_bytes
    return tr.scaled(want / max(total, 1.0))


def fig7_traces(names) -> list:
    """``[(name, Trace)]`` for fig7's traces called ``names``, in
    ``FIG7_RECIPES`` order, each scaled to ~TARGET_PKTS packets."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.constants import Fabric
    from repro_torch.core.topology import build_xcym
    from repro_torch.workloads.hlo import trace_from_hlo
    from repro_torch.workloads.mapping import DeviceMap
    from repro_torch.workloads.synthetic import synthetic_dnn_trace

    dm = DeviceMap(build_xcym(N_CHIPS, N_MEM, Fabric.WIRELESS), N_DEV)
    out = []
    for name, model, sched in FIG7_RECIPES:
        if name not in names:
            continue
        if model is None:
            tr = trace_from_hlo((FIXTURES / "fig7_psum.hlo.txt").read_text(),
                                dm, name="compiled:psum-step")
        else:
            tr = synthetic_dnn_trace(get_config(model), dm, tokens=2048,
                                     n_layers_cap=1, schedule=sched)
        out.append((name, autoscale(tr)))
    return out


def fig7_point(name: str, tr, fabric: str, sim):
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    return SweepPoint(N_CHIPS, N_MEM, Fabric[fabric], trace=tr, sim=sim,
                      name=f"{name}/{fabric.lower()}")


def fig8_point(case: dict, sim):
    """One fig8 point from its fixture case: closed-loop memory traffic at
    ``load`` with a ``max_outstanding`` window, or an app closed-loop."""
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    from repro_torch.memory import DramTimingParams, MemSweepSpec
    if "app" in case:
        return SweepPoint(N_CHIPS, N_MEM, Fabric(case["fabric"]),
                          load=case["load"], app=case["app"],
                          closed_loop=True, sim=sim)
    dram = DramTimingParams(max_outstanding=case["max_outstanding"])
    return SweepPoint(N_CHIPS, N_MEM, Fabric(case["fabric"]), sim=sim,
                      mem=MemSweepSpec(load=case["load"], dram=dram))


def fig9_quality_point(case: dict, sim, load: float, p_mem: float):
    """A point of fig9's quality grid: link budget x policy x fabric."""
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    from repro_torch.phy import PhySweepSpec
    return SweepPoint(N_CHIPS, N_MEM, Fabric(case["fabric"]), load=load,
                      p_mem=p_mem, sim=sim, phy_spec=PhySweepSpec(
                          link_budget_db=case["budget_db"],
                          policy=case["policy"]))


def fig9_drift_point(case: dict, sim, load: float, p_mem: float,
                     budget_db: float):
    """A point of fig9's drift sweep: aging amplitude x arm (online =
    in-scan re-selection, static = the host pick, or a fixed rate)."""
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    from repro_torch.phy import PhySweepSpec
    arm = case["arm"]
    spec = PhySweepSpec(
        link_budget_db=budget_db,
        policy="adaptive" if arm in ("online", "static") else arm,
        drift_amp_db=case["amp_db"], reselect=arm == "online")
    return SweepPoint(N_CHIPS, N_MEM, Fabric.WIRELESS, load=load,
                      p_mem=p_mem, sim=sim, phy_spec=spec)


def bcast_trace(payload: float):
    """The fixture's small multicast trace: 8 devices, an all-reduce phase
    of two multicasts and a permute phase."""
    from repro_torch.workloads.trace import Trace, mcast, p2p, phase
    return Trace("bcast-lossy", 8, [
        phase([mcast(0, (2, 3, 4, 5, 6, 7), payload),
               mcast(4, (0, 1, 2, 3), payload)], label="c0:all-reduce"),
        phase([p2p(1, 6, payload), p2p(6, 1, payload)], label="c1:permute")])


def fig9_packed(kind: str, case: dict, device):
    """fig9's single-point runs, packed by the port: ``mc_trace`` (the
    one-shot all-reduce of 16 devices over the lossy channel), ``bcast``
    (the small multicast trace) or ``replay`` (the short-birth living
    point that drains early)."""
    from repro_torch.core import simulator, traffic
    from repro_torch.core.constants import DEFAULT_PHY, Fabric, SimParams
    from repro_torch.core.routing import compute_routing
    from repro_torch.core.topology import build_xcym
    from repro_torch.phy import PhySweepSpec
    topo = build_xcym(N_CHIPS, N_MEM, Fabric.WIRELESS)
    if kind == "mc_trace":
        from repro_torch.workloads.mapping import DeviceMap
        from repro_torch.workloads.schedules import expand_collective
        from repro_torch.workloads.trace import Trace
        phases = expand_collective("all-reduce", case["payload_bytes"],
                                   N_DEV, DeviceMap(topo, N_DEV),
                                   schedule="oneshot", label="ar")
        tt = traffic.from_trace(topo, Trace("oneshot-ar", N_DEV, phases),
                                DEFAULT_PHY.pkt_flits)
        spec = PhySweepSpec(link_budget_db=case["budget_db"],
                            max_retx=case["max_retx"])
        sim = SimParams(cycles=case["cycles"], warmup=0)
    elif kind == "bcast":
        tt = traffic.from_trace(topo, bcast_trace(case["payload_bytes"]),
                                DEFAULT_PHY.pkt_flits)
        spec = PhySweepSpec(link_budget_db=case["budget_db"],
                            max_retx=case["max_retx"])
        sim = SimParams(cycles=case["cycles"], warmup=0)
    else:
        tt = traffic.uniform_random(topo, case["load"], case["p_mem"],
                                    case["birth_cycles"],
                                    DEFAULT_PHY.pkt_flits,
                                    seed=case["traffic_seed"])
        spec = PhySweepSpec(link_budget_db=case["budget_db"],
                            drift_amp_db=case["drift_amp_db"],
                            reselect=case["reselect"], seed=case["seed"])
        sim = SimParams(cycles=case["cycles"], warmup=case["warmup"])
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          sim, phy_spec=spec, device=device)


def fig9_checks(quality, drift, mc, emit=None) -> dict:
    """fig9's hard checks, as ``benchmarks/fig9_lossy_channel.py`` states
    them, on ``quality``/``drift`` lists of ``(case, Metrics)`` and the
    broadcast-ARQ trace's ``Metrics``; ``emit`` (e.g. ``print``) gets the
    script's ``fig9``, ``fig9.drift``, ``fig9.mc_trace`` and
    ``fig9.check`` rows.  Returns each check's truth value."""
    emit = emit or (lambda row: None)
    pols = ("adaptive", "fixed:0", "fixed:-1")
    by = {(c["budget_db"], c["policy"], c["fabric"]): m for c, m in quality}
    budgets = sorted({c["budget_db"] for c, _ in quality})
    emit("fig9,point,budget_db,policy,throughput,goodput_gbps,air_eff,"
         "retx_rate,dropped,retx_energy_share,pj_bit,rate_hist")
    for c, m in quality:
        hist = ";".join(f"{k}:{v}" for k, v in m.wl_rate_hist.items())
        emit(f"fig9,{m.name},{c['budget_db']},{c['policy']},"
             f"{m.throughput:.4f},{m.wl_goodput_gbps:.1f},"
             f"{m.wl_air_eff:.4f},{m.wl_retx_rate:.3f},{m.wl_dropped},"
             f"{m.retx_energy_share:.3f},{m.energy_pj_bit:.2f},{hist}")
    adapt_ok, agg = True, {p: 0.0 for p in pols}
    for b in budgets:
        ma = by[(b, "adaptive", 2)]
        agg["adaptive"] += ma.wl_goodput_gbps
        for pol in pols[1:]:
            mf = by[(b, pol, 2)]
            agg[pol] += mf.wl_goodput_gbps
            ok = ma.wl_air_eff >= mf.wl_air_eff * 0.98
            adapt_ok &= ok
            emit(f"fig9.check,adaptive_air_eff_ge_{pol},budget={b},"
                 f"{ma.wl_air_eff:.4f}>={mf.wl_air_eff:.4f},{ok}")
    agg_ok = all(agg["adaptive"] >= agg[p] for p in pols[1:])
    emit(f"fig9.check,adaptive_aggregate_goodput,{agg['adaptive']:.0f}>="
         f"max({agg['fixed:0']:.0f},{agg['fixed:-1']:.0f}),{agg_ok}")
    wired_ok = True
    for b in budgets:
        for fab in (0, 1):
            base = by[(b, pols[0], fab)]
            for pol in pols[1:]:
                m = by[(b, pol, fab)]
                wired_ok &= (m.flits_delivered == base.flits_delivered
                             and m.avg_pkt_latency == base.avg_pkt_latency
                             and m.avg_pkt_energy_pj
                             == base.avg_pkt_energy_pj)
    emit(f"fig9.check,adaptive_goodput_dominates,{adapt_ok}")
    emit(f"fig9.check,wireline_unaffected,{wired_ok}")
    dby = {(c["amp_db"], c["arm"]): m for c, m in drift}
    emit("fig9.drift,point,amp_db,arm,air_eff,goodput_gbps,resel,"
         "retx_rate,pj_bit,rate_hist")
    for c, m in drift:
        hist = ";".join(f"{k}:{v}" for k, v in m.wl_rate_hist.items())
        emit(f"fig9.drift,{m.name},{c['amp_db']},{c['arm']},"
             f"{m.wl_air_eff:.4f},{m.wl_goodput_gbps:.1f},{m.wl_resel},"
             f"{m.wl_retx_rate:.3f},{m.energy_pj_bit:.2f},{hist}")
    drift_ok = True
    for amp in sorted({a for a, _ in dby}):
        mo, mst = dby[(amp, "online")], dby[(amp, "static")]
        pairs = [("online", "static", mo, mst)] + [
            ("online", arm, mo, dby[(amp, arm)])
            for arm in ("fixed:0", "fixed:-1")] + [
            ("static", "fixed:0", mst, dby[(amp, "fixed:0")])]
        for a, b, ma, mb in pairs:
            ok = ma.wl_air_eff >= mb.wl_air_eff * 0.98
            drift_ok &= ok
            emit(f"fig9.check,{a}_air_eff_ge_{b},amp={amp},"
                 f"{ma.wl_air_eff:.4f}>={mb.wl_air_eff:.4f},{ok}")
    mc_ok = bool(mc.trace_done and mc.wl_dropped_payload == 0)
    emit(f"fig9.mc_trace,oneshot-ar@22dB,phases={mc.phases_done}/"
         f"{mc.n_phases},dropped_payload={mc.wl_dropped_payload},"
         f"retx={mc.wl_nacks},{mc_ok}")
    return dict(adaptive_dominates=bool(adapt_ok),
                aggregate_dominates=bool(agg_ok),
                wireline_unaffected=bool(wired_ok),
                drift_ordering_holds=bool(drift_ok),
                mc_trace_done=mc_ok)


# ---- fig2-fig6 and the ablations (benchmarks/fig2_uniform.py ..
# benchmarks/ablations.py)

PAPER_FIGS = ("fig2", "fig3", "fig4", "fig5", "fig6", "ablations")
PAPER_SIM = dict(cycles=10_000, warmup=1_000)      # benchmarks/common.py
LOADS = [0.01, 0.02, 0.05, 0.10, 0.15, 0.20, 0.30]  # fig3
OFF = {1: 0.20, 4: 0.80, 8: 0.90}                    # fig4: off-chip share
P_MEMS = (0.2, 0.4, 0.6, 0.8)                        # fig5
DENSITY_CLUSTERS = (4, 8, 16, 32)                    # ablations
FABRIC_ORDER = ("SUBSTRATE", "INTERPOSER", "WIRELESS")


def paper_sim(d: dict):
    """``SimParams`` from the fixture's record of one (``mac`` an int)."""
    from repro_torch.core.constants import MacMode, SimParams
    return SimParams(**dict(d, mac=MacMode(d["mac"])))


def gain(new: float, base: float) -> float:
    """Percentage improvement of `new` over `base` (higher better)."""
    return 100.0 * (new / base - 1.0)


def reduction(new: float, base: float) -> float:
    """Percentage reduction of `new` vs `base` (lower better)."""
    return 100.0 * (1.0 - new / base)


def paper_calls(fig: str, sim) -> list:
    """The figure's calls, in the script's order: ``("sweep", [points])``
    for each ``run_sweep_batched`` call, ``("density", cluster)`` for each
    WI-density point of the ablations (1C4M wireless, one WI per
    ``cluster`` cores; a topology past the simulator's 16 WIs is skipped,
    as the script does)."""
    from repro_torch.core.constants import (Fabric, MacMode, PhyParams,
                                            SimParams, WMAX)
    from repro_torch.core.sweep import SweepPoint
    from repro_torch.core.topology import build_xcym

    fabs = [Fabric[f] for f in FABRIC_ORDER]
    W, I = Fabric.WIRELESS, Fabric.INTERPOSER
    if fig == "fig2":
        return [("sweep", [SweepPoint(4, 4, f, load=1.0, p_mem=0.2, sim=sim)
                           for f in fabs])]
    if fig == "fig3":
        return [("sweep", [SweepPoint(4, 4, f, load=ld, p_mem=0.2, sim=sim)
                           for f in fabs for ld in LOADS])]
    if fig == "fig4":
        return [("sweep", [SweepPoint(nc, 4, fab, load=1.0, p_mem=0.2,
                                      sim=sim)
                           for nc in (1, 4, 8) for fab in (W, I)])]
    if fig == "fig5":
        return [("sweep", [SweepPoint(4, 4, fab, load=1.0, p_mem=pm,
                                      sim=sim)
                           for pm in P_MEMS for fab in (W, I)])]
    if fig == "fig6":
        from repro_torch.core.traffic import APP_MODELS
        return [("sweep", [SweepPoint(4, 4, fab, load=1.0, app=app, sim=sim)
                           for app in APP_MODELS for fab in (W, I)])]
    if fig != "ablations":
        raise ValueError(f"unknown figure {fig!r}")
    sim_tok = SimParams(cycles=sim.cycles, warmup=sim.warmup,
                        mac=MacMode.TOKEN)
    sim_nosleep = SimParams(cycles=sim.cycles, warmup=sim.warmup,
                            sleepy_rx=False)
    calls = [("sweep", [
        SweepPoint(4, 4, W, load=1.0, sim=sim),
        SweepPoint(4, 4, W, load=1.0, sim=sim,
                   phy=PhyParams(wireless_medium="matching")),
        SweepPoint(4, 4, W, load=1.0, sim=sim,
                   phy=PhyParams(wireless_medium="single",
                                 wireless_flit_cycles=5)),
        SweepPoint(4, 4, W, load=1.0, sim=sim_tok),
        SweepPoint(4, 4, W, load=0.1, sim=sim_nosleep),
        SweepPoint(4, 4, W, load=0.1, sim=sim)])]
    phy2 = PhyParams(interposer_links_per_pair=2)
    calls.append(("sweep", [SweepPoint(nc, 4, fab, load=1.0, sim=sim,
                                       phy=phy2)
                            for nc in (4, 8) for fab in (W, I)]))
    calls += [("density", c) for c in DENSITY_CLUSTERS
              if build_xcym(1, 4, W, wi_cluster_cores=c).n_wi <= WMAX]
    return calls


def density_packed(cluster: int, sim, device):
    """The ablations' WI-density point through the raw API: topology,
    routing, uniform traffic at load 1.0 with 20% memory accesses,
    ``simulator.pack``; returns ``(PackedSim, offered_load)``."""
    from repro_torch.core import simulator, traffic
    from repro_torch.core.constants import Fabric, PhyParams
    from repro_torch.core.routing import compute_routing
    from repro_torch.core.topology import build_xcym
    topo = build_xcym(1, 4, Fabric.WIRELESS, wi_cluster_cores=cluster)
    rt = compute_routing(topo)
    tt = traffic.uniform_random(topo, 1.0, 0.2, sim.cycles, 64)
    return (simulator.pack(topo, rt, tt, PhyParams(), sim, device=device),
            tt.offered_load)


def run_paper_calls(calls, sim, device, extra=None) -> list:
    """Run a figure's calls; the ``Metrics`` of every point, in order.
    ``extra`` maps a call's index to points appended to that
    ``run_sweep_batched`` call as further lanes (their ``Metrics`` come
    last, after every point of the figure)."""
    from repro_torch.core import simulator
    from repro_torch.core.metrics import compute_metrics
    from repro_torch.core.sweep import run_sweep_batched
    extra = extra or {}
    ms, tail = [], []
    for j, (kind, arg) in enumerate(calls):
        if kind == "sweep":
            more = list(extra.get(j, ()))
            out = run_sweep_batched(list(arg) + more, device=device)
            ms += out[:len(arg)]
            tail += out[len(arg):]
        else:
            ps, load = density_packed(arg, sim, device)
            ms.append(compute_metrics(ps, simulator.run(ps),
                                      f"density_{arg}", load))
    return ms + tail


def point_case(p) -> dict:
    """A ``SweepPoint`` as the fixture records it (the PHY fields that
    differ from the default)."""
    import dataclasses
    from repro_torch.core.constants import DEFAULT_PHY
    sim = dataclasses.asdict(p.sim)
    sim["mac"] = int(p.sim.mac)
    return dict(kind="sweep", n_chips=p.n_chips, n_mem=p.n_mem,
                fabric=int(p.fabric), load=p.load, p_mem=p.p_mem,
                app=p.app, name=p.name, wireless_weight=p.wireless_weight,
                phy={k: v for k, v in dataclasses.asdict(p.phy).items()
                     if v != getattr(DEFAULT_PHY, k)},
                sim=sim)


def call_cases(calls, sim) -> list:
    """Every point of ``calls`` (made with ``sim``) as the fixture
    records it."""
    import dataclasses
    out = [point_case(p) for kind, pts in calls if kind == "sweep"
           for p in pts]
    simd = dict(dataclasses.asdict(sim), mac=int(sim.mac))
    out += [dict(kind="density", n_chips=1, n_mem=4, fabric=2,
                 wi_cluster_cores=c, load=1.0, p_mem=0.2,
                 name=f"density_{c}", sim=simd)
            for kind, c in calls if kind == "density"]
    return out


def paper_report(fig: str, ms) -> dict:
    """The script's CSV rows (paper-reported rows included), the truth
    value of each ``*.check`` row and every derived gain or reduction at
    full precision, from the figure's ``Metrics`` in point order."""
    rows: list = []
    der: dict = {}
    emit = rows.append
    if fig == "fig2":
        emit("fig2,fabric,bw_gbps_core,avg_pkt_energy_pj,thr_flits_cyc_core")
        for f, m in zip(FABRIC_ORDER, ms):
            emit(f"fig2,{f},{m.bw_gbps_core:.3f},{m.avg_pkt_energy_pj:.0f},"
                 f"{m.throughput:.4f}")
        s, i, w = ms
        emit(f"fig2.check,wireless_highest_bw,"
             f"{w.bw_gbps_core > i.bw_gbps_core > s.bw_gbps_core}")
        emit(f"fig2.check,wireless_lowest_energy,"
             f"{w.avg_pkt_energy_pj < i.avg_pkt_energy_pj < s.avg_pkt_energy_pj}")
        der["fig2.derived,bw_gain_vs_interposer_pct"] = gain(
            w.bw_gbps_core, i.bw_gbps_core)
        der["fig2.derived,energy_gain_vs_interposer_pct"] = reduction(
            w.avg_pkt_energy_pj, i.avg_pkt_energy_pj)
        der["fig2.derived,energy_gain_vs_substrate_pct"] = reduction(
            w.avg_pkt_energy_pj, s.avg_pkt_energy_pj)
        for k, v in der.items():
            emit(f"{k},{v:.1f}")
    elif fig == "fig3":
        emit("fig3,fabric,load,avg_pkt_latency_cycles,throughput")
        low = {}
        grid = [(f, ld) for f in FABRIC_ORDER for ld in LOADS]
        for (f, ld), m in zip(grid, ms):
            emit(f"fig3,{f},{ld},{m.avg_pkt_latency:.1f},"
                 f"{m.throughput:.4f}")
            if ld == LOADS[0]:
                low[f] = m.avg_pkt_latency
        emit(f"fig3.check,wireless_lowest_latency,"
             f"{low['WIRELESS'] < low['INTERPOSER'] < low['SUBSTRATE']}")
    elif fig in ("fig4", "fig5"):
        if fig == "fig4":
            emit("fig4,config,off_chip_frac,bw_gain_pct,energy_gain_pct,"
                 "thr_wireless,thr_interposer")
            keys = [f"{nc}C4M" for nc in (1, 4, 8)]
            lead = [f"fig4,{k},{OFF[nc]}" for k, nc in zip(keys, (1, 4, 8))]
        else:
            emit("fig5,p_mem,bw_gain_pct,energy_gain_pct,thr_wireless,"
                 "thr_interposer")
            keys = [str(pm) for pm in P_MEMS]
            lead = [f"fig5,{k}" for k in keys]
        for j, (k, head) in enumerate(zip(keys, lead)):
            mw, mi = ms[2 * j], ms[2 * j + 1]
            bw = gain(mw.throughput, mi.throughput)
            en = reduction(mw.avg_pkt_energy_pj, mi.avg_pkt_energy_pj)
            der[f"{fig},{k},bw_gain_pct"] = bw
            der[f"{fig},{k},energy_gain_pct"] = en
            emit(f"{head},{bw:.1f},{en:.1f},"
                 f"{mw.throughput:.4f},{mi.throughput:.4f}")
        if fig == "fig4":
            emit("fig4.paper,8C4M,0.90,11.0,37.0,,  # paper-reported gains")
        else:
            gains = [(der[f"fig5,{k},bw_gain_pct"],
                      der[f"fig5,{k},energy_gain_pct"]) for k in keys]
            emit(f"fig5.check,gains_stay_positive,"
                 f"{all(b > 0 and e > 0 for b, e in gains)}")
            emit("fig5.paper,floors,10.0,35.0,,  # paper-reported "
                 "asymptotic floors")
    elif fig == "fig6":
        from repro_torch.core.traffic import APP_MODELS
        emit("fig6,app,lat_reduction_pct,energy_reduction_pct,"
             "lat_wireless,lat_interposer")
        lat, en = [], []
        for j, app in enumerate(APP_MODELS):
            mw, mi = ms[2 * j], ms[2 * j + 1]
            lat.append(reduction(mw.avg_pkt_latency, mi.avg_pkt_latency))
            en.append(reduction(mw.avg_pkt_energy_pj, mi.avg_pkt_energy_pj))
            der[f"fig6,{app},lat_reduction_pct"] = lat[-1]
            der[f"fig6,{app},energy_reduction_pct"] = en[-1]
            emit(f"fig6,{app},{lat[-1]:.1f},{en[-1]:.1f},"
                 f"{mw.avg_pkt_latency:.1f},{mi.avg_pkt_latency:.1f}")
        der["fig6.derived,avg_latency_reduction_pct"] = sum(lat) / len(lat)
        der["fig6.derived,avg_energy_reduction_pct"] = sum(en) / len(en)
        emit(f"fig6.derived,avg_latency_reduction_pct,"
             f"{der['fig6.derived,avg_latency_reduction_pct']:.1f}")
        emit(f"fig6.derived,avg_energy_reduction_pct,"
             f"{der['fig6.derived,avg_energy_reduction_pct']:.1f}")
        emit("fig6.paper,averages,54.0,45.0,,  # paper-reported averages")
        emit(f"fig6.check,all_apps_improve,"
             f"{all(v > 0 for v in lat) and all(v > 0 for v in en)}")
    elif fig == "ablations":
        emit("ablation,variant,thr,lat,energy_pj_pkt")
        base, match, single, tok, nosleep, sleep = ms[:6]
        emit(f"ablation,crossbar(default),{base.throughput:.4f},"
             f"{base.avg_pkt_latency:.1f},{base.avg_pkt_energy_pj:.0f}")
        for name, m in [("matching", match), ("single_channel_strict",
                                              single)]:
            emit(f"ablation,{name},{m.throughput:.4f},"
                 f"{m.avg_pkt_latency:.1f},{m.avg_pkt_energy_pj:.0f}")
        emit(f"ablation,token_mac,{tok.throughput:.4f},"
             f"{tok.avg_pkt_latency:.1f},{tok.avg_pkt_energy_pj:.0f}")
        der["ablation.derived,ctrl_mac_thr_gain_pct"] = gain(
            base.throughput, tok.throughput)
        der["ablation.derived,sleepy_rx_energy_saving_pct"] = reduction(
            sleep.avg_pkt_energy_pj, nosleep.avg_pkt_energy_pj)
        for k in ("ablation.derived,ctrl_mac_thr_gain_pct",
                  "ablation.derived,sleepy_rx_energy_saving_pct"):
            emit(f"{k},{der[k]:.1f}")
        x2 = ms[6:10]
        for j, nc in enumerate((4, 8)):
            k = f"ablation,interposer_x2_{nc}C4M_bw_gain_pct"
            der[k] = gain(x2[2 * j].throughput, x2[2 * j + 1].throughput)
            emit(f"{k},{der[k]:.1f},,")
        for m in ms[10:]:
            cluster = m.name.split("_")[1]
            emit(f"ablation,wi_density_1per{cluster}cores_1C4M,"
                 f"{m.throughput:.4f},{m.avg_pkt_latency:.1f},"
                 f"{m.avg_pkt_energy_pj:.0f}")
    else:
        raise ValueError(f"unknown figure {fig!r}")
    checks = {}
    for r in rows:
        head, val = r.rsplit(",", 1)
        if head.split(",", 1)[0].endswith(".check"):
            checks[head] = val == "True"
    return dict(rows=rows, checks=checks, derived=der)
