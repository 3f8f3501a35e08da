"""The port's sweep entry points end to end on the CPU.

``run_point(device="cpu")`` on the five golden points (four open-loop,
one closed-loop memory point) must match the committed goldens (integers
exact, floats rel 1e-6 — the bound of ``tests/test_golden_metrics.py``:
the energy sums run in another order than XLA's); ``run_sweep_batched``
must equal a ``run_point`` loop exactly; a ``phy_spec`` packs the lossy
program on the wireless fabric and nothing on a wireline one.
"""
import dataclasses
import json
import math
import pathlib

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
from repro_torch.memory import MemSweepSpec  # noqa: E402
from repro_torch.phy.channel import PhySweepSpec  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
SIM = SimParams(cycles=1500, warmup=300, seed=0)
GOLDENS = {
    "wireless_4c4m_load02": dict(fabric=Fabric.WIRELESS, load=0.2),
    "interposer_4c4m_load02": dict(fabric=Fabric.INTERPOSER, load=0.2),
    "substrate_4c4m_load02": dict(fabric=Fabric.SUBSTRATE, load=0.2),
    "app_canneal_wireless_4c4m": dict(fabric=Fabric.WIRELESS, load=1.0,
                                      app="canneal"),
    # closed-loop memory: the golden's load is the MemSweepSpec's
    "memcl_wireless_4c4m_load03": dict(fabric=Fabric.WIRELESS, load=0.0,
                                       mem=MemSweepSpec(load=0.3)),
}
INT_FIELDS = ("pkts_delivered", "flits_delivered", "flits_injected")
FLOAT_FIELDS = ("offered_load", "throughput", "bw_gbps_core",
                "avg_pkt_latency", "avg_pkt_energy_pj", "energy_pj_bit")
MEM_FIELDS = ("amat_cycles", "amat_reads", "mem_reads", "mem_writes",
              "mem_row_hit_rate", "mem_queue_cycles", "mem_service_cycles",
              "mem_bw_gbps", "outst_peak")


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
    assert ("memory" in want) == bool(m.mem_reads or m.mem_writes)
    for f in MEM_FIELDS if "memory" in want else ():
        assert float(getattr(m, f)) == pytest.approx(want["memory"][f],
                                                     rel=1e-6), (name, f)


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


def test_pack_rejects_phy_points(system):
    """A ``phy_spec`` packs the lossy program on the wireless fabric; a
    fabric without wireless interfaces rejects it and packs the exact
    ideal-channel program (its key and tables unchanged)."""
    topo, rt = system
    tt = traffic.uniform_random(topo, 0.2, 0.2, 200, 64)
    ps = simulator.pack(topo, rt, tt, topo.phy, SimParams(cycles=200),
                        phy_spec=PhySweepSpec(), device="cpu")
    assert ps.phy_on and ps.phy_link is not None
    assert dict(ps.shape_key()[:4])["phy_on"]
    wired = build_xcym(4, 4, Fabric.SUBSTRATE)
    rt_w = compute_routing(wired)
    tt_w = traffic.uniform_random(wired, 0.2, 0.2, 200, 64)
    a = simulator.pack(wired, rt_w, tt_w, wired.phy, SimParams(cycles=200),
                       phy_spec=PhySweepSpec(), device="cpu")
    b = simulator.pack(wired, rt_w, tt_w, wired.phy, SimParams(cycles=200),
                       device="cpu")
    assert not a.phy_on and a.phy_link is None
    assert a.shape_key() == b.shape_key()
    for x, y in zip(a.ss, b.ss):
        assert torch.equal(x, y)
