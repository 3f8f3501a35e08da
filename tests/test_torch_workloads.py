"""The port's trace workloads against the JAX package, case by case after
``tests/test_workloads.py``.

Host side (exact): the port's copies of the trace IR, the device map, the
collective schedules, the HLO parser, the synthetic generator and
``traffic.from_trace`` produce objects and arrays equal to the
reference's.  Engine side: each trace point runs through the port on the
CPU and through the JAX engine, and every ``SimState`` leaf must be equal;
``Metrics`` agree with integers exact and floats within rel 1e-6.  Runs
that take the JAX engine thousands of cycles continue in the port from a
carried mid-run state of the JAX engine (a run cut at that cycle).  Then the reference test's own
property is asserted on the port's result.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro.configs import base as jconfigs  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import PhyParams as JPhy  # noqa: E402
from repro.core.constants import SimParams as JSim  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro.interconnect import fabric as jfabric  # noqa: E402
from repro.interconnect import hlo_traffic as jhlo_traffic  # noqa: E402
from repro.workloads import hlo as jhlo  # noqa: E402
from repro.workloads import mapping as jmapping  # noqa: E402
from repro.workloads import schedules as jschedules  # noqa: E402
from repro.workloads import synthetic as jsynthetic  # noqa: E402
from repro.workloads import trace as jtrace  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.constants import Fabric as TFabric  # noqa: E402
from repro_torch.core.constants import PhyParams as TPhy  # noqa: E402
from repro_torch.core.constants import SimParams as TSim  # noqa: E402
from repro_torch.core.routing import compute_routing as trouting  # noqa: E402
from repro_torch.core.topology import build_xcym as tbuild  # noqa: E402
from repro_torch.interconnect import fabric as tfabric  # noqa: E402
from repro_torch.interconnect import hlo_traffic as thlo_traffic  # noqa: E402
from repro_torch.workloads import hlo as thlo  # noqa: E402
from repro_torch.workloads import mapping as tmapping  # noqa: E402
from repro_torch.workloads import schedules as tschedules  # noqa: E402
from repro_torch.workloads import synthetic as tsynthetic  # noqa: E402
from repro_torch.workloads import trace as ttrace  # noqa: E402
from test_workloads import HLO_FIXTURE  # noqa: E402
from repro_torch import carry  # noqa: E402
from torch_compare import (assert_metrics_equal, assert_states_equal,  # noqa: E402
                           assert_tables_equal, np_tree, port_continue,
                           port_packed)

PKT = 64
# driver metadata: a carried state keeps the budget it was cut at
META = ("cycles_run", "drain_cycle")
FIXTURES = pathlib.Path(__file__).parent / "torch_fixtures"


class _J:        # the reference's modules
    configs, traffic, trace, mapping = jconfigs, jtraffic, jtrace, jmapping
    schedules, hlo, synthetic, hlo_traffic = (jschedules, jhlo, jsynthetic,
                                              jhlo_traffic)
    fabric, build, Fabric, Phy, Sim, sweep = (jfabric, jbuild, JFabric,
                                              JPhy, JSim, jsweep)


class _T:        # the port's copies
    configs, traffic, trace, mapping = tconfigs, ttraffic, ttrace, tmapping
    schedules, hlo, synthetic, hlo_traffic = (tschedules, thlo, tsynthetic,
                                              thlo_traffic)
    fabric, build, Fabric, Phy, Sim, sweep = (tfabric, tbuild, TFabric,
                                              TPhy, TSim, tsweep)


def both(build):
    """The same construction in both packages, held equal; the port's."""
    a, b = build(_J), build(_T)
    assert_tables_equal(a, b, "host")
    return b


def _wl(m, fabric="WIRELESS"):
    return m.build(4, 4, m.Fabric[fabric])


def _dm(m, n, fabric="WIRELESS"):
    return m.mapping.DeviceMap(_wl(m, fabric), n)


def _mc_tables(m, topo, n_dst=4):
    """One multicast to devices 4.. (remote chips) and its unicasts."""
    t = m.trace
    dsts = tuple(range(4, 4 + n_dst))
    mc = t.Trace("mc", 8, [t.phase([t.mcast(0, dsts, 256.0)], "c")])
    uni = t.Trace("uni", 8, [t.phase([t.p2p(0, d, 256.0) for d in dsts],
                                     "c")])
    return (m.traffic.from_trace(topo, mc, PKT),
            m.traffic.from_trace(topo, uni, PKT))


def _run_pair(topo_name, build, phy_kw=None, cycles=2000):
    """Pack ``build(pkg) -> table`` in both packages (SimStatic held
    equal), run both engines from cycle 0 and hold the states equal."""
    phy_kw = phy_kw or {}
    out = []
    for m in (_J, _T):
        topo = _wl(m, topo_name)
        tt = build(m, topo)
        kw = {} if m is _J else {"device": "cpu"}
        pack = jsim.pack if m is _J else tsim.pack
        out.append(pack(topo, (jrouting if m is _J else trouting)(topo), tt,
                        m.Phy(**phy_kw), m.Sim(cycles=cycles, warmup=0),
                        **kw))
    ps_j, ps_t = out
    assert_states_equal(np_tree(ps_j.ss), np_tree(ps_t.ss))
    want = np_tree(jsim.run(ps_j))
    got = np_tree(tsim.run(ps_t))
    assert_states_equal(want, got)
    return ps_t, got


# ---------------------------------------------------------------- IR / map

def test_trace_ir_and_mapping():
    dj, dm = _dm(_J, 8), _dm(_T, 8)
    for k in ("dev_chip", "dev_switch", "dev_mem", "mem_switch",
              "serving_wi"):
        assert_tables_equal(getattr(dj, k), getattr(dm, k), k)
    wl = _wl(_T)
    for d in range(8):
        assert wl.chip_of[dm.node_switch(d)] == dm.dev_chip[d]
    assert wl.is_mem[dm.node_switch(ttrace.MEM_NODE(0))]
    with pytest.raises(ValueError):
        ttrace.TraceMessage(0, (0,), 1.0)
    with pytest.raises(ValueError):
        ttrace.TraceMessage(0, (), 1.0)


def test_trace_scaled_floors_at_emission():
    tt = both(lambda m: m.traffic.from_trace(_wl(m), m.trace.Trace(
        "t", 8, [m.trace.phase([m.trace.p2p(0, 4, 1e6)], "c")]).scaled(1e-9),
        PKT))
    assert (tt.births != ttraffic.NO_PKT).sum() == 1


# ---------------------------------------------------------------- schedules

def test_ring_allreduce_phase_structure():
    phases = both(lambda m: m.schedules.expand_collective(
        "all-reduce", 1024.0, 8, _dm(m, 8), schedule="ring"))
    assert len(phases) == 2 * 7
    assert all(len(ph.messages) == 8 for ph in phases)
    assert not any(m.is_multicast for ph in phases for m in ph.messages)


def test_oneshot_allreduce_is_multicast():
    phases = both(lambda m: m.schedules.expand_collective(
        "all-reduce", 1024.0, 8, _dm(m, 8), schedule="oneshot"))
    assert len(phases) == 1 and len(phases[0].messages) == 8
    assert all(m.is_multicast and len(m.dsts) == 7
               for m in phases[0].messages)


def test_strided_groups_span_chips():
    assert tschedules._blocks(16, 4, stride=4) == \
        jschedules._blocks(16, 4, stride=4)
    calls = both(lambda m: m.synthetic.layer_collectives(
        m.configs.get_config("granite-8b"), _dm(m, 16), 1024,
        n_layers_cap=1))
    assert any(c.stride == 4 and c.group_size == 4 for c in calls)
    dm = _dm(_T, 16)
    phases = both(lambda m: m.schedules.expand_collective(
        "all-reduce", 1e3, 4, _dm(m, 16), schedule="ring", stride=4))
    assert any(dm.node_chip(m.src) != dm.node_chip(m.dsts[0])
               for m in phases[0].messages)


def test_hierarchical_structure_and_parallel_blocks():
    phases = both(lambda m: m.schedules.expand_collective(
        "all-reduce", 1e6, 8, _dm(m, 8), schedule="hierarchical"))
    assert len(phases) == 3
    assert all(m.is_multicast for m in phases[1].messages)
    tp = both(lambda m: m.schedules.expand_collective(
        "all-reduce", 64.0, 2, _dm(m, 8), schedule="ring"))
    assert len(tp) == 2 and len(tp[0].messages) == 8


# ------------------------------------------------------------ HLO pipeline

def test_collective_sequence_orders_and_trip_counts():
    seq = both(lambda m: m.hlo_traffic.collective_sequence(HLO_FIXTURE, 8))
    assert [c.op for c in seq] == ["all-gather", "all-reduce"]
    assert seq[1].repeat == 3 and seq[0].payload_bytes == 512 * 4


def test_collective_sequence_keeps_group_stride_through_trace():
    hlo = HLO_FIXTURE.replace("replica_groups={{0,1,2,3,4,5,6,7}}",
                              "replica_groups={{0,4},{1,5},{2,6},{3,7}}")
    tr = both(lambda m: m.hlo.trace_from_hlo(hlo, _dm(m, 8), name="strided",
                                             schedule="ring"))
    dm = _dm(_T, 8)
    msgs = [m for p in tr.phases if "all-reduce" in p.label
            for m in p.messages]
    assert msgs and all(dm.node_chip(m.src) != dm.node_chip(m.dsts[0])
                        for m in msgs)


def test_trace_from_hlo_builds_phases():
    tr = both(lambda m: m.hlo.trace_from_hlo(HLO_FIXTURE, _dm(m, 8),
                                             name="toy"))
    assert tr.n_phases > 0 and tr.meta["n_collectives"] == 2


def test_fig7_traces_equal_reference():
    """fig7's five traces at paper size (16 devices): the port builds them
    equal to the reference, the compiled one from the HLO text fixture."""
    hlo = (FIXTURES / "fig7_psum.hlo.txt").read_text()
    for name, model, sched in (("compiled", None, "auto"),
                               ("gemma-7b", "gemma-7b", "auto"),
                               ("gemma-7b-oneshot", "gemma-7b", "oneshot"),
                               ("mixtral-8x22b", "mixtral-8x22b", "auto"),
                               ("llama3-405b", "llama3-405b", "auto")):
        def build(m):
            if model is None:
                return m.hlo.trace_from_hlo(hlo, _dm(m, 16),
                                            name="compiled:psum-step")
            return m.synthetic.synthetic_dnn_trace(
                m.configs.get_config(model), _dm(m, 16), tokens=2048,
                n_layers_cap=1, schedule=sched)
        tr = both(build)
        assert tr.n_phases > 0, name


def test_synthetic_trace_shapes():
    tr = both(lambda m: m.synthetic.synthetic_dnn_trace(
        m.configs.get_config("granite-8b"), _dm(m, 8), tokens=1024,
        n_layers_cap=2))
    assert tr.n_phases > 0 and tr.meta["source"] == "synthetic"


def test_residency_traffic_touches_memory():
    tr = both(lambda m: m.hlo.trace_from_collectives(
        [m.hlo_traffic.CollectiveCall("all-reduce", 2048.0, 8)], _dm(m, 8),
        "r", residency=True))
    rd = [p for p in tr.phases if p.label.endswith("/rd")]
    wr = [p for p in tr.phases if p.label.endswith("/wr")]
    assert rd and all(m.src < 0 for m in rd[0].messages)
    assert wr and all(m.dsts[0] < 0 for m in wr[0].messages)


# ------------------------------------------------------- emission semantics

def test_emission_wireline_expands_multicast():
    tt = both(lambda m: m.traffic.from_trace(_wl(m, "INTERPOSER"), m.trace.Trace(
        "t", 8, [m.trace.phase([m.trace.mcast(0, (2, 4, 6), 768.0)], "c")]),
        PKT))
    live = tt.dests[tt.births != ttraffic.NO_PKT]
    assert len(live) == 9 and (live >= 0).all() and tt.n_mc == 0


def test_emission_wireless_groups_by_serving_wi():
    tt = both(lambda m: m.traffic.from_trace(_wl(m), m.trace.Trace(
        "t", 8, [m.trace.phase([m.trace.mcast(0, (2, 3, 4), 256.0)], "c")]),
        PKT))
    assert tt.n_mc == 1 and tt.mc_member[0].sum() == 2
    assert list(tt.phase_need) == [2, 1]


# ------------------------------------- multicast broadcast (acceptance gate)

def test_multicast_occupies_shared_channel_once():
    """Leaf for leaf with JAX on the strict single channel: one multicast
    to 2 WIs costs ONE air occupancy per flit and 2 receptions, the
    unicasts one per destination; transmit energy is counted once.  The
    unicast run (1 400 cycles in JAX) continues in the port from JAX's
    state at cycle 1 280."""
    phy = dict(wireless_medium="single", wireless_flit_cycles=5)
    ps, st_mc = _run_pair("WIRELESS", lambda m, topo: _mc_tables(m, topo)[0],
                          phy, cycles=4000)
    assert int(st_mc["cur_phase"]) == int(ps.ss.n_phases)
    assert int(st_mc["wl_tx_flits"]) == PKT
    assert int(st_mc["wl_rx_flits"]) == PKT * 2
    topo_j = _wl(_J)
    ps_u = jsim.pack(topo_j, jrouting(topo_j), _mc_tables(_J, topo_j)[1],
                     JPhy(**phy), JSim(cycles=1536, warmup=0))
    mid = jsim.run(ps_u, cycles=1280)
    st_uni, = port_continue([ps_u], [mid], 1280, 1536)
    assert_states_equal(np_tree(jsim.run(ps_u)), st_uni, skip=META)
    assert int(st_uni["cur_phase"]) == int(ps_u.ss.n_phases)
    assert int(st_uni["wl_tx_flits"]) == int(st_uni["wl_rx_flits"]) == PKT * 4
    rx0 = int(ps.ss.rx0)
    n_wi = int(ps.ss.n_wi)
    assert st_mc["counts_into"][rx0:rx0 + n_wi].sum() == PKT
    rx0 = int(ps_u.ss.rx0)
    assert st_uni["counts_into"][rx0:rx0 + n_wi].sum() == PKT * 4


def test_multicast_wireline_is_replicated_unicasts():
    """Leaf for leaf with JAX: on the interposer a multicast IS its
    unicasts, wire cost included (the unicast comparator runs in JAX: its
    table equals the port's, and unicast steps are held elsewhere)."""
    _, st_mc = _run_pair("INTERPOSER",
                         lambda m, topo: _mc_tables(m, topo)[0], cycles=1000)
    ip = _wl(_J, "INTERPOSER")
    uni = both(lambda m: _mc_tables(m, _wl(m, "INTERPOSER"))[1])
    st_uni = np_tree(jsim.run(jsim.pack(
        ip, jrouting(ip), jtraffic.TrafficTable(**{
            f: getattr(uni, f) for f in uni.__dataclass_fields__}),
        JPhy(), JSim(cycles=1000, warmup=0))))
    assert int(st_mc["flits_del"]) == int(st_uni["flits_del"]) == PKT * 4
    n_links = _wl(_T, "INTERPOSER").n_links
    assert st_mc["counts_into"][:n_links].sum() \
        == st_uni["counts_into"][:n_links].sum() > PKT * 4


@pytest.mark.parametrize("medium", ["crossbar", "matching"])
def test_multicast_crossbar_delivers_all_copies(medium):
    ps, st = _run_pair("WIRELESS", lambda m, topo: _mc_tables(m, topo)[0],
                       dict(wireless_medium=medium), cycles=600)
    assert int(st["cur_phase"]) == int(ps.ss.n_phases)
    assert int(st["wl_tx_flits"]) == PKT
    assert int(st["wl_rx_flits"]) == 2 * PKT


# ------------------------------------------------------------ phase barrier

def test_phase_barrier_orders_dependent_phases():
    """Leaf for leaf with JAX; ring-style dependent exchanges close their
    phases in order, and the port's metrics and per-collective summary
    account for every cycle and flit."""
    def build(m, topo):
        msgs = [m.trace.p2p(d, (d + 1) % 8, 256.0) for d in range(8)]
        tr = m.trace.Trace("ring", 8, [m.trace.phase(msgs, f"s{i}")
                                       for i in range(4)])
        return m.traffic.from_trace(topo, tr, PKT)

    ps, st = _run_pair("WIRELESS", build, cycles=1000)
    ends = st["phase_end"][:4]
    assert int(st["cur_phase"]) == 4 and (np.diff(ends) > 0).all()
    m = tmetrics.compute_metrics(ps, carry.state_from_numpy(st, "cpu"),
                                 "ring", 0.0)
    assert m.trace_done and m.trace_cycles == ends[-1]
    assert tmetrics.phase_durations(m)[0] == ends[0]
    summary = tmetrics.collective_summary(m, build(_T, _wl(_T)).phase_labels)
    assert sum(r["cycles"] for r in summary.values()) == ends[-1]
    assert sum(r["flits"] for r in summary.values()) == int(st["flits_del"])


def test_trace_points_batch_like_singles():
    """The three fabrics of one trace ride one port batch; each lane's
    metrics equal the JAX package's (integers exact, floats rel 1e-6; the
    JAX package's own tests hold its batch equal to its single runs)."""
    def pts(m):
        tr = m.synthetic.synthetic_dnn_trace(
            m.configs.get_config("whisper-tiny"), _dm(m, 8), tokens=256,
            n_layers_cap=1).scaled(1e-4)
        return [m.sweep.SweepPoint(4, 4, m.Fabric[f], trace=tr,
                                   sim=m.Sim(cycles=512, warmup=0))
                for f in ("WIRELESS", "INTERPOSER", "SUBSTRATE")]

    pts_j, pts_t = pts(_J), pts(_T)
    batched = tsweep.run_sweep_batched(pts_t, device="cpu")
    for got, want in zip(batched, jsweep.run_sweep_batched(pts_j)):
        assert_metrics_equal(got, want)
    assert batched[0].phases_done > 0


# ------------------------------------------------- analytic 2x cross-check

@pytest.mark.parametrize("fabric", ["WIRELESS", "INTERPOSER"])
def test_cycle_link_energy_within_2x_of_analytic(fabric):
    """The toy HLO trace: the JAX engine to 128 cycles before its drain, the
    port from that state to the end (states leaf for leaf), then the 2x
    gate on the port's cycle link energy against its ``price_table``
    (whose value equals the reference's)."""
    tt_j = jtraffic.from_trace(
        _wl(_J, fabric), jhlo.trace_from_hlo(
            HLO_FIXTURE, _dm(_J, 8, fabric), name="toy").scaled(0.25), PKT)
    tt = both(lambda m: m.traffic.from_trace(_wl(m, fabric), m.hlo.trace_from_hlo(
        HLO_FIXTURE, _dm(m, 8, fabric), name="toy").scaled(0.25), PKT))
    topo_j = _wl(_J, fabric)
    ps = jsim.pack(topo_j, jrouting(topo_j), tt_j, JPhy(),
                   JSim(cycles=16000, warmup=0))
    end = int(jsim.run(ps).drain_cycle)
    mid = jsim.run(ps, cycles=end - 128)
    got, = port_continue([ps], [mid], end - 128, end)
    assert_states_equal(np_tree(jsim.run(ps, cycles=end)), got, skip=META)
    assert int(got["cur_phase"]) == tt.n_phases
    ps_t = port_packed(ps)
    m = tmetrics.compute_metrics(ps_t, carry.state_from_numpy(got, "cpu"),
                                 "toy", 0.0, cycles=end)
    bits = m.flits_delivered * 32
    topo = _wl(_T, fabric)
    _total, analytic = tfabric.price_table(topo, tt, PKT)
    assert analytic == jfabric.price_table(topo_j, tt_j, PKT)[1]
    ratio = m.energy_breakdown["links"] / bits / analytic
    assert 0.5 <= ratio <= 2.0, (fabric, ratio)
    spec = tfabric.FabricSpec("trace", analytic, 16.0, 1.0)
    assert tfabric.price_traffic(bits / 8, 1, spec).energy_mj * 1e9 / bits \
        == pytest.approx(analytic)
    assert_tables_equal(jfabric.spec_from_topology(topo_j),
                        tfabric.spec_from_topology(topo), "spec")


def test_trace_points_need_cuda_unless_cpu_is_asked_for():
    """A multicast trace point asked of the port without a card raises; it
    never runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    t = ttrace
    tr = t.Trace("mc", 8, [t.phase([t.mcast(0, (4, 5, 6, 7), 256.0)], "c")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.run_sweep_batched([tsweep.SweepPoint(
            4, 4, TFabric.WIRELESS, trace=tr, sim=TSim(cycles=200,
                                                        warmup=0))])
