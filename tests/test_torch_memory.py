"""The port's closed-loop memory path against the JAX package, case by
case after ``tests/test_memory.py``.

Host side: the port's copies of the bank model, the closed-loop table
builder and trace memory-op emission must produce arrays equal to the
reference's.  Engine side: each closed-loop point runs through the port
on the CPU and through the JAX engine; every ``SimState`` leaf must be
equal (integers and the float32 sums alike: they add small integers), and
``Metrics`` agree with integers exact and floats within rel 1e-6.  Then
the reference test's own property is asserted on the port's result.  The
JAX runs of the file share one module-scoped fixture; sizes are cut to a
few hundred cycles (the CPU runs the port's step at ~10 ms a cycle).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro import memory as jmem  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import SimParams as JSim  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro.workloads import trace as jtrace  # noqa: E402
from repro_torch import memory as tmem  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.constants import Fabric as TFabric  # noqa: E402
from repro_torch.core.constants import SimParams as TSim  # noqa: E402
from repro_torch.core.routing import compute_routing as trouting  # noqa: E402
from repro_torch.core.topology import build_xcym as tbuild  # noqa: E402
from repro_torch.workloads import trace as ttrace  # noqa: E402
from torch_compare import (assert_metrics_equal, assert_states_equal,  # noqa: E402
                           assert_tables_equal, np_tree)

J_WL, T_WL = jbuild(4, 4, JFabric.WIRELESS), tbuild(4, 4, TFabric.WIRELESS)
J_RT, T_RT = jrouting(J_WL), trouting(T_WL)
FABRICS = ("WIRELESS", "INTERPOSER", "SUBSTRATE")


def _both(build, *a, **kw):
    """The same host construction in both packages: ``build(pkg)``."""
    return build(_J, *a, **kw), build(_T, *a, **kw)


class _J:        # the reference's host modules
    mem, traffic, trace, topo, rt = jmem, jtraffic, jtrace, J_WL, J_RT
    Sim, Fabric, sweep = JSim, JFabric, jsweep


class _T:        # the port's copies
    mem, traffic, trace, topo, rt = tmem, ttraffic, ttrace, T_WL, T_RT
    Sim, Fabric, sweep = TSim, TFabric, tsweep


def _run_both(tt_j, tt_t, sim_kw):
    """Pack a table in each package, run both engines, compare the states
    leaf for leaf; returns the port's final state as numpy."""
    ps_j = jsim.pack(J_WL, J_RT, tt_j, J_WL.phy, JSim(**sim_kw))
    ps_t = tsim.pack(T_WL, T_RT, tt_t, T_WL.phy, TSim(**sim_kw),
                     device="cpu")
    assert ps_t.mem_on == ps_j.mem_on
    want = np_tree(jsim.run(ps_j))
    got = np_tree(tsim.run(ps_t))
    assert_states_equal(want, got)
    return got


# ------------------------------------------------------- reference model

def test_service_reference_basics():
    """Exact: the port's bank model returns the reference's arrays."""
    arr = np.array([[0, 0, 0, 5], [1, 0, 0, 5], [2, 0, 0, 6], [2, 1, 0, 6]])
    out_j = jmem.service(arr, jmem.DramTimingParams(t_row_hit=30,
                                                    t_row_miss=75))
    dram = tmem.DramTimingParams(t_row_hit=30, t_row_miss=75)
    start, done, hit = tmem.service(arr, dram)
    for a, b in zip(out_j, (start, done, hit)):
        assert_tables_equal(np.asarray(a), np.asarray(b), "service")
    assert list(hit) == [False, True, False, False]
    assert done[0] == 1 + 75
    assert start[1] == done[0] and done[1] == done[0] + 30
    assert done[2] == done[1] + 75
    assert done[3] == 3 + 75


def test_service_reference_properties_hypothesis():
    """Exact, on random request streams: port and reference bank models
    agree, and the reference test's hit/miss properties hold."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    dram = tmem.DEFAULT_DRAM

    @settings(max_examples=25, deadline=None)
    @given(st.lists(
        st.tuples(st.integers(0, 500), st.integers(0, tmem.MEM_CH - 1),
                  st.integers(0, dram.n_banks - 1),
                  st.integers(0, dram.n_rows - 1)),
        min_size=1, max_size=40))
    def check(reqs):
        reqs.sort(key=lambda r: r[0])
        arr = np.array(reqs)
        start, done, hit = tmem.service(arr, dram)
        for a, b in zip(jmem.service(arr, jmem.DEFAULT_DRAM),
                        (start, done, hit)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert (start >= arr[:, 0] + 1).all()
        svc = done - start
        assert (svc == np.where(hit, dram.t_row_hit, dram.t_row_miss)).all()

    check()


# ------------------------------------------------------- table encoding

def test_closed_loop_table_pairing():
    """Exact: ``closed_loop_uniform`` arrays equal the reference's; the
    pairing invariants hold on the port's table."""
    tt_j, tt = _both(lambda m: m.mem.closed_loop_uniform(
        m.topo, 0.4, 800, 64, dram=m.mem.DramTimingParams(max_outstanding=4),
        seed=2))
    assert_tables_equal(tt_j, tt, "closed_loop_uniform")
    n_cores = T_WL.n_cores
    assert tt.n_sources == n_cores + T_WL.n_mem * tmem.MEM_CH
    reqs = np.argwhere((tt.mem_op == tmem.MEM_READ)
                       | (tt.mem_op == tmem.MEM_WRITE))
    assert len(reqs)
    for i, k in reqs:
        rr, rs = tt.reply_row[i, k], tt.reply_slot[i, k]
        assert i < n_cores and rr >= n_cores
        assert divmod(rr - n_cores, tmem.MEM_CH)[1] == tt.mem_ch[i, k]
        assert tt.req_src[rr, rs] == i
        assert tt.req_birth[rr, rs] == tt.births[i, k]
        assert tt.births[rr, rs] == ttraffic.NO_PKT


# ------------------------------------------- engine semantics (acceptance)

def test_outstanding_never_exceeds_cap():
    """Leaf for leaf with JAX (both caps as lanes of one port batch); the
    in-flight window binds exactly at the cap."""
    sim_kw = dict(cycles=300, warmup=50)
    pss_j, pss_t = [], []
    for cap in (2, 8):
        tt_j, tt_t = _both(lambda m: m.mem.closed_loop_uniform(
            m.topo, 1.0, 300, 64,
            dram=m.mem.DramTimingParams(max_outstanding=cap), seed=5))
        pss_j.append(jsim.pack(J_WL, J_RT, tt_j, J_WL.phy, JSim(**sim_kw)))
        pss_t.append(tsim.pack(T_WL, T_RT, tt_t, T_WL.phy, TSim(**sim_kw),
                               device="cpu"))
    out = np_tree(tsim.run_batch(pss_t))
    for g, (cap, ps_j) in enumerate(zip((2, 8), pss_j)):
        got = {k: v[g] for k, v in out.items()}
        assert_states_equal(np_tree(jsim.run(ps_j)), got)
        assert int(got["outst_peak"].max()) == cap


def test_engine_bank_timing_matches_reference_model():
    """Leaf for leaf with JAX; two spaced same-bank reads reproduce the
    bank model's miss-then-hit arithmetic in the port's reply births."""
    def build(m):
        core_sw = np.nonzero(m.topo.is_core)[0].astype(np.int32)
        mem_sw = np.nonzero(m.topo.is_mem)[0].astype(np.int32)
        b = m.mem.MemTableBuilder(m.mem.mem_source_rows(core_sw, mem_sw),
                                  mem_sw, 64, m.mem.DramTimingParams())
        for birth in (0, 400):
            b.request(0, m.mem.MEM_READ, 0, 1, 3, 7,
                      reply_dest=int(core_sw[0]), birth=birth)
        return b.build(0.0)

    tt_j, tt_t = _both(build)
    assert_tables_equal(tt_j, tt_t, "MemTableBuilder")
    st = _run_both(tt_j, tt_t, dict(cycles=1000, warmup=0))
    dram = tmem.DramTimingParams()
    row = T_WL.n_cores + 1                       # stack 0, channel 1
    r1, r2 = int(st["rdy"][row, 0]), int(st["rdy"][row, 1])
    assert r2 - r1 == 400 - dram.t_row_miss + dram.t_row_hit
    assert int(st["mem_row_hits"].sum()) == 1
    assert int(st["mem_reads"].sum()) == 2
    assert int(st["amat_pkts"]) == 2
    assert int(st["outst"].sum()) == 0
    assert int(st["drain_cycle"]) < 1000         # drained early


def test_closed_loop_batched_equals_single():
    """The three fabrics in one port batch: metrics equal the JAX
    package's single-point runs (integers exact, floats rel 1e-6), and the
    wireless lane equals the port's own single run exactly."""
    sim_kw = dict(cycles=300, warmup=50)

    def pts(m):
        spec = m.mem.MemSweepSpec(
            load=0.3, dram=m.mem.DramTimingParams(max_outstanding=6))
        return [m.sweep.SweepPoint(4, 4, m.Fabric[f], mem=spec,
                                   sim=m.Sim(**sim_kw)) for f in FABRICS]

    pts_j, pts_t = _both(pts)
    batched = tsweep.run_sweep_batched(pts_t, device="cpu")
    for p, b in zip(pts_j, batched):
        assert_metrics_equal(b, jsweep.run_sweep_batched([p])[0])
    single = tsweep.run_sweep_batched(pts_t[:1], device="cpu")[0]
    assert dataclasses.asdict(single) == dataclasses.asdict(batched[0]) \
        or np.isnan(single.amat_cycles)
    assert batched[0].mem_reads > 0 and batched[0].per_stack


def test_amat_grows_toward_saturation():
    """Metrics equal JAX's (integers exact, floats rel 1e-6); AMAT and the
    stacks' delivered bandwidth grow with the load."""
    def pts(m):
        dram = m.mem.DramTimingParams(max_outstanding=16)
        return [m.sweep.SweepPoint(4, 4, m.Fabric.WIRELESS,
                                   sim=m.Sim(cycles=400, warmup=50),
                                   mem=m.mem.MemSweepSpec(load=ld, dram=dram))
                for ld in (0.05, 0.8)]

    pts_j, pts_t = _both(pts)
    lo, hi = tsweep.run_sweep_batched(pts_t, device="cpu")
    for got, want in zip((lo, hi), jsweep.run_sweep_batched(pts_j)):
        assert_metrics_equal(got, want)
    assert lo.amat_reads > 0 and hi.amat_reads > 0
    assert hi.amat_cycles > lo.amat_cycles
    assert hi.mem_bw_gbps > lo.mem_bw_gbps


# --------------------------------------------------- open-loop escape hatch

def test_application_closed_loop_escape_hatch():
    """Exact tables both ways; canneal closed-loop through the port's
    ``run_point`` equals JAX's metrics and measures round-trip reads."""
    a_j, a = _both(lambda m: m.traffic.application(
        m.topo, m.traffic.APP_MODELS["canneal"], 800, 64, seed=3))
    c_j, c = _both(lambda m: m.traffic.application(
        m.topo, m.traffic.APP_MODELS["canneal"], 800, 64, seed=3,
        closed_loop=True))
    assert_tables_equal(a_j, a, "open-loop")
    assert_tables_equal(c_j, c, "closed-loop")
    assert not a.has_mem and c.has_mem
    kw = dict(load=1.0, app="canneal", closed_loop=True)
    m = tsweep.run_point(4, 4, TFabric.WIRELESS, sim=TSim(cycles=400,
                                                          warmup=50),
                         device="cpu", **kw)
    assert_metrics_equal(m, jsweep.run_point(
        4, 4, JFabric.WIRELESS, sim=JSim(cycles=400, warmup=50), **kw))
    assert m.mem_reads > 0 and m.amat_reads > 0
    assert m.amat_cycles > 0 and m.mem_writes == 0


# --------------------------------------------------------- trace mem ops

def test_trace_mem_ops_round_trip():
    """Exact tables and leaf-for-leaf states; the trace's read and write
    round trips complete and every credit returns."""
    def build(m):
        t = m.trace
        tr = t.Trace("m", 8, [
            t.phase([t.mem_read(d, -(d % 4 + 1), 256.0) for d in range(8)],
                    "rd"),
            t.phase([t.mem_write(0, -1, 512.0)], "wr"),
        ])
        return m.traffic.from_trace(m.topo, tr, 64)

    tt_j, tt = _both(build)
    assert_tables_equal(tt_j, tt, "from_trace")
    assert tt.has_mem and tt.phase_need[0] == 16 and tt.phase_need[1] == 4
    st = _run_both(tt_j, tt, dict(cycles=3000, warmup=0))
    assert int(st["cur_phase"]) == 2
    assert int(st["amat_pkts"]) == 8
    assert int(st["mem_writes"].sum()) == 2
    assert int(st["outst"].sum()) == 0


def test_trace_mem_op_validation():
    with pytest.raises(ValueError, match="MEM_NODE"):
        ttrace.TraceMessage(0, (1,), 64.0, op="read")
    with pytest.raises(ValueError, match="source"):
        ttrace.TraceMessage(-1, (-2,), 64.0, op="write")


def test_memory_points_need_cuda_unless_cpu_is_asked_for():
    """A closed-loop point asked of the port without a card raises; it
    never runs on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.run_point(4, 4, TFabric.WIRELESS, 0.0,
                         mem=tmem.MemSweepSpec(load=0.3),
                         sim=TSim(cycles=200, warmup=50))
