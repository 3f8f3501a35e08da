"""The port's cycle step on trace and closed-loop memory tables against
the JAX engine, leaf by leaf.

- ``pack``: the port packs memory and trace tables into a ``SimStatic``
  equal to the reference's, and ``init_state`` gives the reference's
  closed-loop leaves (real shapes under ``mem_on``);
- the step, from carried states: JAX runs each point to a mid-run cycle,
  the port continues that state (all points of one step program as lanes
  of one batch), and every ``SimState`` leaf must equal the JAX engine's
  at the end (integers and the float32 sums alike).  Memory points run on
  all three fabrics; a one-shot all-reduce trace (multicast groups) on the
  wireless fabric with the crossbar and the single-channel media, and as
  replicated unicasts on the interposer and the substrate;
- the chunked driver with ``mem_on`` and on a trace: it exits early where
  the JAX driver does, and equals JAX's monolithic run.

The driver metadata ``cycles_run``/``drain_cycle`` of a carried state is
the budget it was cut at, so those two leaves are left out where a state
was carried.
"""
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro.core import simulator as jsim  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import PhyParams as JPhy  # noqa: E402
from repro.core.constants import SimParams as JSim  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro.memory import closed_loop_uniform as jclosed  # noqa: E402
from repro.workloads import trace as jtrace  # noqa: E402
from repro.workloads.mapping import DeviceMap as JDeviceMap  # noqa: E402
from repro.workloads.schedules import expand_collective as jexpand  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.constants import Fabric as TFabric  # noqa: E402
from repro_torch.core.constants import PhyParams as TPhy  # noqa: E402
from repro_torch.core.constants import SimParams as TSim  # noqa: E402
from repro_torch.core.routing import compute_routing as trouting  # noqa: E402
from repro_torch.core.topology import build_xcym as tbuild  # noqa: E402
from repro_torch.memory import closed_loop_uniform as tclosed  # noqa: E402
from repro_torch.workloads import trace as ttrace  # noqa: E402
from repro_torch.workloads.mapping import DeviceMap as TDeviceMap  # noqa: E402
from repro_torch.workloads.schedules import expand_collective as texpand  # noqa: E402
from torch_compare import (assert_states_equal, np_tree,  # noqa: E402
                           port_continue, port_packed)

META = ("cycles_run", "drain_cycle")
# (fabric, medium, kind): the step programs' cases
CASES = {
    "mem_wireless": ("WIRELESS", "crossbar", "mem"),
    "mem_interposer": ("INTERPOSER", "crossbar", "mem"),
    "mem_substrate": ("SUBSTRATE", "crossbar", "mem"),
    "mc_wireless_crossbar": ("WIRELESS", "crossbar", "trace"),
    "mc_wireless_single": ("WIRELESS", "single", "trace"),
    "uni_interposer": ("INTERPOSER", "crossbar", "trace"),
    "uni_substrate": ("SUBSTRATE", "crossbar", "trace"),
}
SEGMENT = {"mem": (384, 512), "trace": (512, 640)}


def oneshot(pkg_trace, expand, dm, n_dev, nbytes=512.0):
    """A one-shot all-reduce trace: every device multicasts its payload to
    the rest of the group."""
    phases = expand("all-reduce", nbytes, n_dev, dm, schedule="oneshot",
                    label="ar")
    return pkg_trace.Trace("oneshot-ar", n_dev, phases)


def _table(case, port: bool):
    fabric, _, kind = CASES[case]
    topo = (tbuild if port else jbuild)(4, 4, (TFabric if port
                                               else JFabric)[fabric])
    if kind == "mem":
        tt = (tclosed if port else jclosed)(topo, 0.3, 600, 64, seed=2)
    else:
        dm = (TDeviceMap if port else JDeviceMap)(topo, 8)
        tr = oneshot(ttrace if port else jtrace,
                      texpand if port else jexpand, dm, 8)
        tt = (ttraffic if port else jtraffic).from_trace(topo, tr, 64)
    return topo, tt


def _phy(case, port: bool):
    return (TPhy if port else JPhy)(wireless_medium=CASES[case][1])


@pytest.fixture(scope="module")
def packed():
    """Every case packed by JAX, one shape per step program."""
    out = {}
    for kind in ("mem", "trace"):
        names = [c for c in CASES if CASES[c][2] == kind]
        tabs = {c: _table(c, False) for c in names}
        dims = [jsim.pack_dims(*tabs[c]) for c in names]
        floors = {k: max(d[k] for d in dims) for k in dims[0]}
        for c in names:
            topo, tt = tabs[c]
            out[c] = jsim.pack(topo, jrouting(topo), tt, _phy(c, False),
                               JSim(cycles=2048, warmup=100), floors=floors)
    return out


@pytest.fixture(scope="module")
def continued(packed):
    """JAX to the segment's start and end; the port over the segment,
    each step program's cases as lanes of one batch.  Per case: (JAX's
    state at the end, the port's, JAX's state at the start)."""
    res = {}
    for kind, (t0, t1) in SEGMENT.items():
        names = [c for c in CASES if CASES[c][2] == kind]
        pss = [packed[c] for c in names]
        mid = jsim.run_batch(pss, cycles=t0)
        end = np_tree(jsim.run_batch(pss, cycles=t1))
        sts = [jsim.SimState(*(x[g] for x in mid)) for g in range(len(pss))]
        got = port_continue(pss, sts, t0, t1)
        for g, c in enumerate(names):
            res[c] = ({k: v[g] for k, v in end.items()}, got[g], sts[g])
    return res


@pytest.mark.parametrize("case", ["mem_wireless", "mc_wireless_crossbar",
                                  "uni_substrate"])
def test_pack_matches_reference(case):
    """``SimStatic`` and the initial state equal the reference's, byte for
    byte; the step program's flags follow the table."""
    topo_j, tt_j = _table(case, False)
    topo_t, tt_t = _table(case, True)
    sim = dict(cycles=2048, warmup=100)
    ps_j = jsim.pack(topo_j, jrouting(topo_j), tt_j, _phy(case, False),
                     JSim(**sim))
    ps_t = tsim.pack(topo_t, trouting(topo_t), tt_t, _phy(case, True),
                     TSim(**sim), device="cpu")
    assert ps_t.dims == ps_j.dims
    assert ps_t.mem_on == ps_j.mem_on == (CASES[case][2] == "mem")
    assert ps_t.mc_on == (tt_t.n_mc > 0) == case.startswith("mc_")
    assert_states_equal(np_tree(ps_j.ss), np_tree(ps_t.ss))
    st_j = jsim.init_state(*jsim._state_dims(ps_j), mem_on=ps_j.mem_on)
    st_t = tsim.init_state(*tsim._state_dims(ps_t), mem_on=ps_t.mem_on,
                           device="cpu")
    assert_states_equal(np_tree(st_j), np_tree(st_t))


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_from_carried_state(case, continued):
    want, got, _ = continued[case]
    assert_states_equal(want, got, skip=META)
    kind = CASES[case][2]
    if kind == "mem":
        assert int(got["mem_reads"].sum()) > 0 and int(got["amat_pkts"]) > 0
    elif case.startswith("mc_"):
        # multicast on the air: receptions outnumber transmissions
        assert 0 < int(got["wl_tx_flits"]) < int(got["wl_rx_flits"])
    else:
        assert int(got["pkts_del"]) > 0 and int(got["wl_tx_flits"]) == 0


def test_multicast_terms_inert_without_groups(packed, continued):
    """The wireline lanes alone run without the multicast terms (no lane
    has a group); their states equal those of the batch that ran them
    with the wireless lanes, multicast terms on."""
    t0, t1 = SEGMENT["trace"]
    names = ["uni_interposer", "uni_substrate"]
    pss = [packed[c] for c in names]
    assert not any(port_packed(ps).mc_on for ps in pss)
    assert port_packed(packed["mc_wireless_crossbar"]).mc_on
    sts = [continued[c][2] for c in names]
    for c, got in zip(names, port_continue(pss, sts, t0, t1)):
        assert_states_equal(continued[c][1], got)


# ------------------------------------------------ chunked driver, early exit

@pytest.mark.parametrize("kind", ["mem", "trace"])
def test_chunked_equals_monolithic(kind):
    """The port's chunked driver (from cycle 0) stops where JAX's does,
    well before the budget, and equals JAX's monolithic run."""
    topo = jbuild(4, 4, JFabric.WIRELESS)
    if kind == "mem":
        sim = JSim(cycles=1000, warmup=100)
        tt = jclosed(topo, 0.3, 60, 64, seed=2)
    else:
        sim = JSim(cycles=700, warmup=0)
        tt = jtraffic.from_trace(topo, jtrace.Trace("mc", 8, [jtrace.phase(
            [jtrace.mcast(0, (4, 5, 6, 7), 256.0)], "c")]), 64)
    ps = jsim.pack(topo, jrouting(topo), tt, JPhy(), sim)
    chunked = np_tree(jsim.run(ps))
    mono = np_tree(jsim.run(ps, driver="monolithic"))
    ps_t = port_packed(ps)
    got = np_tree(tsim.run_from(
        ps_t.ss, carry.state_from_numpy(np_tree(jsim.init_state(
            *jsim._state_dims(ps), mem_on=ps.mem_on)), "cpu"),
        mem_on=ps.mem_on))
    assert_states_equal(mono, got, skip=("drain_cycle",))
    assert int(got["drain_cycle"]) == int(chunked["drain_cycle"]) \
        < sim.cycles
