"""The port's sweep entry points end to end on the CPU.

``run_point(device="cpu")`` on the four open-loop golden points must match
the committed goldens (integers exact, floats rel 1e-6 — the bound of
``tests/test_golden_metrics.py``: the energy sums run in another order
than XLA's); ``run_sweep_batched`` must equal a ``run_point`` loop
exactly; points whose engine paths are not ported must raise.
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro_torch.core import simulator, traffic  # noqa: E402
from repro_torch.core.constants import Fabric, SimParams  # noqa: E402
from repro_torch.core.routing import compute_routing  # noqa: E402
from repro_torch.core.sweep import (SweepPoint, latency_sweep,  # noqa: E402
                                    run_point, run_sweep_batched)
from repro_torch.core.topology import build_xcym  # noqa: E402
from repro_torch.phy.channel import PhySweepSpec  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
SIM = SimParams(cycles=1500, warmup=300, seed=0)
GOLDENS = {
    "wireless_4c4m_load02": dict(fabric=Fabric.WIRELESS, load=0.2),
    "interposer_4c4m_load02": dict(fabric=Fabric.INTERPOSER, load=0.2),
    "substrate_4c4m_load02": dict(fabric=Fabric.SUBSTRATE, load=0.2),
    "app_canneal_wireless_4c4m": dict(fabric=Fabric.WIRELESS, load=1.0,
                                      app="canneal"),
}
INT_FIELDS = ("pkts_delivered", "flits_delivered", "flits_injected")
FLOAT_FIELDS = ("offered_load", "throughput", "bw_gbps_core",
                "avg_pkt_latency", "avg_pkt_energy_pj", "energy_pj_bit")


@pytest.mark.parametrize("name", list(GOLDENS))
def test_run_point_matches_golden(name):
    golden = json.loads((GOLDEN_DIR / f"{name}.json").read_text())
    assert golden["sim"] == {"cycles": SIM.cycles, "warmup": SIM.warmup,
                             "seed": SIM.seed}
    m = run_point(4, 4, p_mem=0.2, sim=SIM, device="cpu", **GOLDENS[name])
    want = golden["metrics"]
    for f in INT_FIELDS:
        assert int(getattr(m, f)) == want[f], (name, f)
    for f in FLOAT_FIELDS:
        assert getattr(m, f) == pytest.approx(want[f], rel=1e-6), (name, f)
    assert set(m.energy_breakdown) == set(want["energy_breakdown"])
    for k, v in want["energy_breakdown"].items():
        assert m.energy_breakdown[k] == pytest.approx(v, rel=1e-6), (name, k)


def _same(a, b) -> bool:
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def test_batched_equals_run_point_loop():
    """Mixed fabrics, traffic and budgets in one call == one call each."""
    pts = [SweepPoint(4, 4, Fabric.WIRELESS, load=0.4,
                      sim=SimParams(cycles=260, warmup=60)),
           SweepPoint(4, 4, Fabric.INTERPOSER, load=0.4,
                      sim=SimParams(cycles=200, warmup=60, seed=3)),
           SweepPoint(4, 4, Fabric.SUBSTRATE, load=0.4,
                      sim=SimParams(cycles=260, warmup=60)),
           SweepPoint(4, 4, Fabric.WIRELESS, load=1.0, app="fft",
                      sim=SimParams(cycles=230, warmup=60))]
    batched = run_sweep_batched(pts, device="cpu")
    for p, mb in zip(pts, batched):
        ms = run_sweep_batched([p], device="cpu")[0]
        for f in dataclasses.fields(ms):
            assert _same(getattr(mb, f.name), getattr(ms, f.name)), f.name
    assert [m.cycles_run for m in batched] == [260, 200, 260, 230]


def test_latency_sweep_is_one_batch_of_points():
    sim = SimParams(cycles=200, warmup=50)
    curve = latency_sweep(4, 4, Fabric.WIRELESS, [0.1, 0.3], sim=sim,
                          device="cpu")
    assert [m.offered_load for m in curve] == [0.1, 0.3]
    solo = run_point(4, 4, Fabric.WIRELESS, load=0.3, sim=sim, device="cpu")
    assert curve[1].flits_delivered == solo.flits_delivered
    assert curve[1].avg_pkt_energy_pj == solo.avg_pkt_energy_pj


@pytest.fixture(scope="module")
def system():
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    return topo, compute_routing(topo)


def test_pack_rejects_memory_tables(system):
    topo, rt = system
    tt = traffic.application(topo, traffic.APP_MODELS["canneal"], 200, 64,
                             closed_loop=True)
    assert tt.mem_op is not None
    with pytest.raises(NotImplementedError, match="A6"):
        simulator.pack(topo, rt, tt, topo.phy, SimParams(cycles=200),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        run_point(4, 4, Fabric.WIRELESS, 0.0, mem=object(), device="cpu")


def test_pack_rejects_trace_tables(system):
    topo, rt = system
    tt = traffic.uniform_random(topo, 0.2, 0.2, 200, 64)
    tt.phases = np.zeros_like(tt.births)
    tt.phase_need = np.ones(1, np.int32)
    with pytest.raises(NotImplementedError, match="A5"):
        simulator.pack(topo, rt, tt, topo.phy, SimParams(cycles=200),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="A5"):
        traffic.from_trace(topo, object(), 64)


def test_pack_rejects_phy_points(system):
    topo, rt = system
    tt = traffic.uniform_random(topo, 0.2, 0.2, 200, 64)
    with pytest.raises(NotImplementedError, match="A7"):
        simulator.pack(topo, rt, tt, topo.phy, SimParams(cycles=200),
                       phy_spec=PhySweepSpec(), device="cpu")
