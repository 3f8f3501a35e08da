"""fig7's ML traces, fig8's closed-loop memory grid and fig9's lossy
channel, built by the port.

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
