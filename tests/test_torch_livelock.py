"""The one-shot multicast livelock of ``tests/test_livelock_regression.py``
on the port, against the JAX engine leaf by leaf.

The fixed program (store-and-forward receivers under ``rx_hold``) runs the
one-shot all-reduce to completion; the pre-fix program (``rx_hold``
cleared, 16-flit rx buffers) stalls forever.  The port continues carried
JAX states over the cycles that matter: the chunk in which the trace's
last phase closes, the cycles where the two programs part, and a stretch
of the stall.  The driver metadata ``cycles_run``/``drain_cycle`` of a
carried state is the budget it was cut at, so those two leaves are left
out.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
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
from repro.workloads import trace as jtrace  # noqa: E402
from repro.workloads.mapping import DeviceMap as JDeviceMap  # noqa: E402
from repro.workloads.schedules import expand_collective as jexpand  # noqa: E402
from test_torch_trace_step import oneshot  # noqa: E402
from torch_compare import assert_states_equal, np_tree, port_continue  # noqa: E402

META = ("cycles_run", "drain_cycle")


def _livelock_point(cycles: int, pre_fix: bool = False):
    """``test_livelock_regression``'s one-shot all-reduce over 16 devices
    on the wireless fabric; ``pre_fix`` clears ``rx_hold`` and restores
    16-flit rx buffers (the program that livelocked)."""
    topo = jbuild(4, 4, JFabric.WIRELESS)
    tt = jtraffic.from_trace(
        topo, oneshot(jtrace, jexpand, JDeviceMap(topo, 16), 16), 64)
    ps = jsim.pack(topo, jrouting(topo), tt, JPhy(),
                   JSim(cycles=cycles, warmup=0))
    if pre_fix:
        rx0, n_wi = int(ps.ss.rx0), int(ps.ss.n_wi)
        depth = np.asarray(ps.ss.b_depth).copy()
        depth[rx0:rx0 + n_wi] = 16
        ps = dataclasses.replace(ps, ss=ps.ss._replace(
            rx_hold=jnp.asarray(False), b_depth=jnp.asarray(depth)))
    return ps


def test_oneshot_multicast_allreduce_completes():
    """The port closes the trace's last phase: JAX's state at the start of
    the chunk in which that phase closes, continued by the port over the
    chunk."""
    ps = _livelock_point(8000)
    full = jsim.run(ps)
    n_ph = int(ps.ss.n_phases)
    assert int(full.cur_phase) == n_ph
    last = int(np.asarray(full.phase_end)[n_ph - 1])
    t0 = (last - 1) // 128 * 128
    t1 = t0 + 128
    got, = port_continue([ps], [jsim.run(ps, cycles=t0)], t0, t1)
    assert_states_equal(np_tree(jsim.run(ps, cycles=t1)), got, skip=META)
    assert int(got["cur_phase"]) == n_ph
    assert (got["phase_end"][:n_ph] > 0).all()


def test_pre_fix_program_still_livelocks():
    """``rx_hold`` is live data in the port: the pre-fix and the fixed
    programs agree up to cycle 384 and diverge by 512 in JAX; the port,
    continuing the one state of cycle 384 with each program's tables,
    follows each.  From JAX's stalled pre-fix state at cycle 1 536 the
    port makes no progress either and never closes phase 0."""
    pre, fixed = _livelock_point(3000, True), _livelock_point(3000)
    st384 = jsim.run(pre, cycles=384)
    assert_states_equal(np_tree(st384),
                        np_tree(jsim.run(fixed, cycles=384)))
    early = port_continue([pre, fixed], [st384, st384], 384, 512)
    want = [np_tree(jsim.run(p, cycles=512)) for p in (pre, fixed)]
    for w, g in zip(want, early):
        assert_states_equal(w, g, skip=META)
    assert not np.array_equal(early[0]["pkt_src"], early[1]["pkt_src"])
    stalled, = port_continue([pre], [jsim.run(pre, cycles=1536)], 1536,
                             1792)
    assert_states_equal(np_tree(jsim.run(pre, cycles=1792)), stalled,
                        skip=META)
    assert int(stalled["cur_phase"]) == 0
    assert int(stalled["pkts_del"]) == int(jsim.run(pre, cycles=1536)
                                           .pkts_del)
    assert int(jsim.run(fixed).cur_phase) >= 1
