"""Write ``paper_figs_reference.json``: the JAX package's fig2-fig6 and
ablation grids.

Runs the reference scripts themselves (``benchmarks/fig2_uniform.py``,
``fig3_latency.py``, ``fig4_cc_traffic.py``, ``fig5_mc_traffic.py``,
``fig6_apps.py``, ``ablations.py``) with their ``SIM`` set to each set's
cycles, and records what they compute: every point that reaches
``run_sweep_batched`` (and the ablations' WI-density points, which go
through ``simulator.run`` and ``compute_metrics``), each with its case and
every ``Metrics`` field; the number of points of each ``run_sweep_batched``
call; the CSV rows the script prints; the truth value of every
``*.check`` row; and every derived gain or reduction at full precision
(``benchmarks.common.gain``/``reduction`` on the recorded metrics, each
checked against the script's own printed row).

Two sets: ``paper``, the paper's 10 000 cycles with 1 000 of warm-up
(``benchmarks/common.py``'s ``SIM``), which
``benchmarks_torch/paper_figs.py`` holds the card's run against; and
``cut``, 500 cycles with 100 of warm-up, which ``chip_smoke.py``'s
phase 21 holds.  67 points a set.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_paper_figs_reference.py [--sets cut,paper]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmarks import (ablations, common, fig2_uniform, fig3_latency,  # noqa: E402
                        fig4_cc_traffic, fig5_mc_traffic, fig6_apps)
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro.core.constants import DEFAULT_PHY, SimParams  # noqa: E402

OUT = pathlib.Path(__file__).parent / "paper_figs_reference.json"
SETS = {"paper": common.SIM,
        "cut": SimParams(cycles=500, warmup=100)}
FIGS = {"fig2": fig2_uniform, "fig3": fig3_latency, "fig4": fig4_cc_traffic,
        "fig5": fig5_mc_traffic, "fig6": fig6_apps, "ablations": ablations}


def sim_case(sim) -> dict:
    d = dataclasses.asdict(sim)
    d["mac"] = int(sim.mac)
    return d


def point_case(p) -> dict:
    """A ``SweepPoint`` as plain data: every field the figure grids set
    (PHY fields that differ from the default)."""
    assert p.trace is None and p.mem is None and p.dram is None
    assert p.phy_spec is None and not p.closed_loop
    phy = {k: v for k, v in dataclasses.asdict(p.phy).items()
           if v != getattr(DEFAULT_PHY, k)}
    return dict(kind="sweep", n_chips=p.n_chips, n_mem=p.n_mem,
                fabric=int(p.fabric), load=p.load, p_mem=p.p_mem,
                app=p.app, name=p.name,
                wireless_weight=p.wireless_weight, phy=phy,
                sim=sim_case(p.sim))


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def record(mod, sim, run_fn=None, density_fn=None) -> dict:
    """Run ``mod.main()`` with ``SIM = sim``; return its calls and rows.

    ``run_fn(points)`` replaces the real ``run_sweep_batched`` (default:
    the real one); ``density_fn(ps, name, offered_load)`` replaces
    ``simulator.run`` + ``compute_metrics`` of the WI-density loop."""
    calls, rows, density = [], [], []
    real_rsb = mod.run_sweep_batched
    real_run, real_cm = jsimulator.run, jmetrics.compute_metrics

    def rsb(points, *a, **kw):
        assert not a and not kw
        ms = (run_fn or real_rsb)(list(points))
        calls.append((list(points), list(ms)))
        return ms

    def run(ps, *a, **kw):
        return None if density_fn else real_run(ps, *a, **kw)

    def cm(ps, st, name, offered_load, *a, **kw):
        m = density_fn(ps, name, offered_load) if density_fn \
            else real_cm(ps, st, name, offered_load, *a, **kw)
        cluster = int(re.fullmatch(r"density_(\d+)", name).group(1))
        assert ps.topo.n_chips == 1 and ps.topo.n_mem == 4
        density.append((dict(
            kind="density", n_chips=1, n_mem=4, fabric=2,
            wi_cluster_cores=cluster, load=1.0, p_mem=0.2,
            name=name, sim=sim_case(ps.sim)), m))
        return m

    with contextlib.ExitStack() as es:
        es.enter_context(patched(mod, "SIM", sim))
        es.enter_context(patched(mod, "run_sweep_batched", rsb))
        es.enter_context(patched(mod, "emit", rows.append))
        es.enter_context(patched(jsimulator, "run", run))
        es.enter_context(patched(jmetrics, "compute_metrics", cm))
        mod.main()
    return dict(calls=calls, rows=rows, density=density)


def derived(fig: str, calls, density) -> dict:
    """Every gain or reduction the script prints, at full precision,
    keyed by its row's leading fields."""
    gain, red = common.gain, common.reduction
    ms = [m for _, cm in calls for m in cm]
    out = {}
    if fig == "fig2":
        s, i, w = ms
        out["fig2.derived,bw_gain_vs_interposer_pct"] = gain(
            w.bw_gbps_core, i.bw_gbps_core)
        out["fig2.derived,energy_gain_vs_interposer_pct"] = red(
            w.avg_pkt_energy_pj, i.avg_pkt_energy_pj)
        out["fig2.derived,energy_gain_vs_substrate_pct"] = red(
            w.avg_pkt_energy_pj, s.avg_pkt_energy_pj)
    elif fig in ("fig4", "fig5"):
        keys = [f"{nc}C4M" for nc in (1, 4, 8)] if fig == "fig4" \
            else [str(pm) for pm in fig5_mc_traffic.P_MEMS]
        for j, k in enumerate(keys):
            mw, mi = ms[2 * j], ms[2 * j + 1]
            out[f"{fig},{k},bw_gain_pct"] = gain(mw.throughput,
                                                 mi.throughput)
            out[f"{fig},{k},energy_gain_pct"] = red(mw.avg_pkt_energy_pj,
                                                    mi.avg_pkt_energy_pj)
    elif fig == "fig6":
        lat, en = [], []
        for j, app in enumerate(fig6_apps.APP_MODELS):
            mw, mi = ms[2 * j], ms[2 * j + 1]
            lat.append(red(mw.avg_pkt_latency, mi.avg_pkt_latency))
            en.append(red(mw.avg_pkt_energy_pj, mi.avg_pkt_energy_pj))
            out[f"fig6,{app},lat_reduction_pct"] = lat[-1]
            out[f"fig6,{app},energy_reduction_pct"] = en[-1]
        out["fig6.derived,avg_latency_reduction_pct"] = sum(lat) / len(lat)
        out["fig6.derived,avg_energy_reduction_pct"] = sum(en) / len(en)
    elif fig == "ablations":
        base, match, single, tok, nosleep, sleep = calls[0][1]
        out["ablation.derived,ctrl_mac_thr_gain_pct"] = gain(
            base.throughput, tok.throughput)
        out["ablation.derived,sleepy_rx_energy_saving_pct"] = red(
            sleep.avg_pkt_energy_pj, nosleep.avg_pkt_energy_pj)
        x2 = calls[1][1]
        for j, nc in enumerate((4, 8)):
            out[f"ablation,interposer_x2_{nc}C4M_bw_gain_pct"] = gain(
                x2[2 * j].throughput, x2[2 * j + 1].throughput)
    return out


def printed(fig: str, rows: list, key: str) -> str:
    """The script's printed value of derived ``key``."""
    head, field = key.rsplit(",", 1)
    if fig in ("fig4", "fig5", "fig6") and not head.endswith(".derived"):
        col = {"bw_gain_pct": 3, "energy_gain_pct": 4,
               "lat_reduction_pct": 2, "energy_reduction_pct": 3}[field]
        if fig == "fig5":
            col -= 1
        (row,) = [r for r in rows if r.startswith(head + ",")]
        return row.split(",")[col]
    (row,) = [r for r in rows if r.startswith(key + ",")]
    return row.split(",")[len(key.split(","))]


def figure(fig: str, sim) -> dict:
    rec = record(FIGS[fig], sim)
    points = [{"case": point_case(p), "metrics": dataclasses.asdict(m)}
              for pts, ms in rec["calls"] for p, m in zip(pts, ms)]
    points += [{"case": c, "metrics": dataclasses.asdict(m)}
               for c, m in rec["density"]]
    checks = {}
    for r in rec["rows"]:
        if ".check," in r.split(",", 1)[0] + ",":
            head, val = r.rsplit(",", 1)
            checks[head] = {"True": True, "False": False}[val]
    der = derived(fig, rec["calls"], rec["density"])
    for k, v in der.items():
        assert f"{v:.1f}" == printed(fig, rec["rows"], k), (k, v)
    return dict(points=points, rows=rec["rows"], checks=checks, derived=der,
                batches=[len(pts) for pts, _ in rec["calls"]])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sets", default="cut,paper")
    args = ap.parse_args()
    out = json.loads(OUT.read_text()) if OUT.exists() else {"sets": {}}
    for name in args.sets.split(","):
        sim = SETS[name]
        figs = {}
        for fig in FIGS:
            figs[fig] = figure(fig, sim)
            print(f"{name} {fig}: {len(figs[fig]['points'])} points",
                  flush=True)
        out["sets"][name] = {"sim": sim_case(sim), "figs": figs}
        OUT.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
        print(f"wrote {OUT}: set {name}", flush=True)


if __name__ == "__main__":
    main()
