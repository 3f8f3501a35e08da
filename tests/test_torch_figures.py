"""The port's fig2-fig6 and ablation grids, rows and checks
(``benchmarks_torch/figures.py``) against the JAX scripts, and the
variants of those grids no other port test reaches, against the JAX
package.

- Grids: each reference script (``benchmarks/fig2_uniform.py`` ..
  ``ablations.py``) runs with ``run_sweep_batched`` and its WI-density
  runs recorded, not simulated (``make_paper_figs_reference.record``); the
  port's ``paper_calls`` must make the same calls with the same points,
  field by field of every ``SweepPoint``, and
  ``paper_figs_reference.json``'s case lists must be them.
- Rows: the same scripts handed given metrics (the fixture's, for both of
  its sets, and seeded perturbations of them) print their CSV rows; the
  port's ``paper_report`` must print the same rows from the same metrics,
  and its checks and derived values must be the ones those rows show.
- Variants at ``CYCLES`` cycles, port against JAX: 1C4M and 8C4M, two
  interposer links a pair, WI clusters of 8 and 32 cores, and every app
  of ``APP_MODELS`` (integers exact, floats rel 1e-6).
"""
import dataclasses
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "torch_fixtures"))
# ``benchmarks`` splits the CPU into XLA devices when it is the first to
# import jax; one device is jax's own default
os.environ.setdefault("REPRO_XLA_DEVICES", "1")

import make_paper_figs_reference as mk  # noqa: E402
from benchmarks_torch import figures  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import (Fabric, MacMode, PhyParams,  # noqa: E402
                                  SimParams)
from repro.core.routing import compute_routing  # noqa: E402
from repro.core.sweep import SweepPoint, run_sweep_batched  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro_torch.core import constants as tconst  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from torch_compare import assert_metrics_equal  # noqa: E402

CYCLES, WARMUP = 300, 100
FX = figures.fixture("paper_figs_reference.json")


def _plain(x):
    """A dataclass/enum tree as plain data, enums as ints."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if hasattr(x, "value") and isinstance(x, int):
        return int(x)
    return x


def _dummy(points):
    return [jmetrics.Metrics(
        name=f"p{i}", offered_load=0.1, throughput=0.1 + i,
        bw_gbps_core=1.0 + i, avg_pkt_latency=10.0 + i,
        avg_pkt_energy_pj=100.0 + i, energy_pj_bit=1.0, pkts_delivered=1,
        flits_delivered=1, flits_injected=1, energy_breakdown={})
        for i in range(len(points))]


def _recorded(fig, sim, metrics=None):
    """The reference script's calls and rows; its simulations replaced by
    ``metrics`` (JAX ``Metrics`` in point order) or dummies."""
    it = iter(metrics) if metrics is not None else None

    def run_fn(points):
        if it is None:
            return _dummy(points)
        return [next(it) for _ in points]

    def density_fn(ps, name, load):
        return next(it) if it is not None else _dummy([0])[0]

    return mk.record(mk.FIGS[fig], sim, run_fn=run_fn,
                     density_fn=density_fn)


@pytest.mark.parametrize("fig", figures.PAPER_FIGS)
def test_port_grids_equal_the_scripts_grids(fig):
    for set_name in ("paper", "cut"):
        simd = FX["sets"][set_name]["sim"]
        jsim_p = SimParams(**dict(simd, mac=MacMode(simd["mac"])))
        rec = _recorded(fig, jsim_p)
        calls = figures.paper_calls(fig, figures.paper_sim(simd))
        sweeps = [pts for kind, pts in calls if kind == "sweep"]
        assert [len(p) for p in sweeps] == [len(p) for p, _ in rec["calls"]]
        for port_pts, (jax_pts, _) in zip(sweeps, rec["calls"]):
            for a, b in zip(port_pts, jax_pts):
                assert _plain(a) == _plain(b)
        assert [arg for kind, arg in calls if kind == "density"] == \
            [c["wi_cluster_cores"] for c, _ in rec["density"]]
        want = [p["case"] for p in FX["sets"][set_name]["figs"][fig]
                ["points"]]
        assert figures.call_cases(calls, figures.paper_sim(simd)) == want
        assert [mk.point_case(p) for pts, _ in rec["calls"]
                for p in pts] + [c for c, _ in rec["density"]] == want


def _perturbed(ms: list, seed: int) -> list:
    """Seeded changes of the metrics the rows read (NaN included), so
    that every check row takes both truth values over the cases."""
    rng = np.random.default_rng(seed)
    out = []
    for m in ms:
        d = dict(m)
        for k in ("throughput", "bw_gbps_core", "avg_pkt_latency",
                  "avg_pkt_energy_pj"):
            d[k] = float(d[k]) * float(rng.uniform(0.3, 1.7)) \
                if rng.random() > 0.05 else float("nan")
        out.append(d)
    return out


@pytest.mark.parametrize("fig", figures.PAPER_FIGS)
def test_port_rows_equal_the_scripts_rows(fig):
    seen = {}
    cases = [FX["sets"][s]["figs"][fig]["points"] for s in ("paper", "cut")]
    base = [[p["metrics"] for p in pts] for pts in cases]
    for ms in base + [_perturbed(base[0], s) for s in range(6)]:
        rec = _recorded(fig, mk.common.SIM,
                        [jmetrics.Metrics(**m) for m in ms])
        rep = figures.paper_report(fig, [tmetrics.Metrics(**m) for m in ms])
        assert rep["rows"] == rec["rows"]
        checks = {r.rsplit(",", 1)[0]: r.rsplit(",", 1)[1] == "True"
                  for r in rec["rows"]
                  if r.split(",", 1)[0].endswith(".check")}
        assert rep["checks"] == checks
        for k, v in rep["derived"].items():
            # the printed derived value is the port's, rounded
            assert f"{v:.1f}" == mk.printed(fig, rec["rows"], k), k
        for k, v in checks.items():
            seen.setdefault(k, set()).add(v)
    # every check row took both truth values somewhere
    assert all(v == {True, False} for v in seen.values()), seen


def test_fixture_derived_values_follow_the_ports_formulas():
    """The fixture's derived values (computed by the generator from the
    reference's metrics) equal the port's from the same metrics."""
    for s in ("paper", "cut"):
        for fig in figures.PAPER_FIGS:
            want = FX["sets"][s]["figs"][fig]
            rep = figures.paper_report(
                fig, [tmetrics.Metrics(**p["metrics"])
                      for p in want["points"]])
            assert rep["derived"] == want["derived"]
            assert rep["checks"] == want["checks"]
            assert rep["rows"] == want["rows"]


# ---- variants of the grids that no other port test reaches

def _t_point(p: SweepPoint) -> tsweep.SweepPoint:
    sim = tconst.SimParams(**dict(_plain(p.sim), mac=tconst.MacMode(
        int(p.sim.mac))))
    return tsweep.SweepPoint(
        p.n_chips, p.n_mem, tconst.Fabric(int(p.fabric)), load=p.load,
        p_mem=p.p_mem, phy=tconst.PhyParams(**_plain(p.phy)), sim=sim,
        app=p.app)


def _sweep_variant(pts):
    want = run_sweep_batched(pts)
    got = tsweep.run_sweep_batched([_t_point(p) for p in pts], device="cpu")
    for g, w in zip(got, want):
        assert_metrics_equal(g, w)
        assert w.flits_delivered > 0


SIM = SimParams(cycles=CYCLES, warmup=WARMUP)
VARIANTS = {
    "1C4M": [SweepPoint(1, 4, f, load=1.0, p_mem=0.2, sim=SIM)
             for f in (Fabric.WIRELESS, Fabric.INTERPOSER)],
    "8C4M": [SweepPoint(8, 4, f, load=1.0, p_mem=0.2, sim=SIM)
             for f in (Fabric.WIRELESS, Fabric.INTERPOSER)],
    "two_links": [SweepPoint(nc, 4, Fabric.INTERPOSER, load=1.0, sim=SIM,
                             phy=PhyParams(interposer_links_per_pair=2))
                  for nc in (4, 8)],
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_port_matches_jax_on_grid_variants(case):
    _sweep_variant(VARIANTS[case])


def test_port_matches_jax_on_every_app():
    apps = list(jtraffic.APP_MODELS)
    assert apps == list(ttraffic.APP_MODELS)
    _sweep_variant([SweepPoint(4, 4, Fabric.WIRELESS, load=1.0, app=a,
                               sim=SIM) for a in apps])


@pytest.mark.parametrize("cluster", [8, 32])
def test_port_matches_jax_on_wi_density(cluster):
    """The ablations' raw-API WI-density point: topology, routing,
    traffic, ``pack``, ``run``, ``compute_metrics``."""
    topo = build_xcym(1, 4, Fabric.WIRELESS, wi_cluster_cores=cluster)
    rt = compute_routing(topo)
    tt = jtraffic.uniform_random(topo, 1.0, 0.2, SIM.cycles, 64)
    ps = jsim.pack(topo, rt, tt, PhyParams(), SIM)
    want = jmetrics.compute_metrics(ps, jsim.run(ps), f"density_{cluster}",
                                    tt.offered_load)
    tps, load = figures.density_packed(
        cluster, tconst.SimParams(cycles=CYCLES, warmup=WARMUP), "cpu")
    assert tps.topo.n_wi == topo.n_wi
    got = tmetrics.compute_metrics(tps, tsim.run(tps), f"density_{cluster}",
                                   load)
    assert_metrics_equal(got, want)
    assert want.flits_delivered > 0
