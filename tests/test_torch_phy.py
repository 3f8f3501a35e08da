"""The port's lossy PHY (CRC/ARQ, drops, broadcast ARQ) against the JAX
package; mirrors ``tests/test_phy.py``.

- the CRC hash: ``repro_torch.phy.retx`` on numpy (uint32) and on torch
  tensors (int64 masked to 32 bits) equals the reference's hash, fail
  draw and host ARQ reference over random and edge uids, attempts and
  seeds (0, 0xFFFFFFFF, values whose products wrap);
- ``pack`` with a ``phy_spec``: every ``SimStatic`` leaf equals the
  reference's (the u32 seed held as int64), the step flags and
  ``shape_key`` carry ``phy_on``/``drift_on``/``reselect``, and a
  wireline fabric packs the exact pre-PHY program;
- the step, from carried JAX states, every ``SimState`` leaf equal at the
  end: a lossy wireless point (NACKs, drops), a broadcast-ARQ multicast
  trace, and a closed-loop memory point over the lossy channel (the
  window credited and reply slots tombstoned on drops);
- the engine's NACK, drop and crossing counters equal the host ARQ
  reference once the network drains, packets are conserved with drops,
  and ``run_sweep_batched`` over a small PHY grid equals the JAX sweep
  metric for metric.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import DEFAULT_PHY as JPHY  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import SimParams as JSim  # noqa: E402
from repro.core.metrics import compute_metrics as jmetrics  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro.memory import DramTimingParams as JDram  # noqa: E402
from repro.memory import closed_loop_uniform as jclosed  # noqa: E402
from repro.phy import PhySweepSpec as JSpec  # noqa: E402
from repro.phy import retx as jretx  # noqa: E402
from repro.workloads.trace import Trace, mcast, p2p, phase  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.constants import DEFAULT_PHY as TPHY  # noqa: E402
from repro_torch.core.constants import Fabric as TFabric  # noqa: E402
from repro_torch.core.constants import SimParams as TSim  # noqa: E402
from repro_torch.core.metrics import (compute_metrics,  # noqa: E402
                                      inflight_flits)
from repro_torch.core.routing import compute_routing as trouting  # noqa: E402
from repro_torch.core.topology import build_xcym as tbuild  # noqa: E402
from repro_torch.phy import PhySweepSpec as TSpec  # noqa: E402
from repro_torch.phy import retx  # noqa: E402
from torch_compare import (assert_metrics_equal,  # noqa: E402
                           assert_states_equal, np_tree, port_continue,
                           port_packed)

META = ("cycles_run", "drain_cycle")
SEEDS = (0, 9, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)
NO_PKT = 2**31 - 1


def _uids_attempts(rng):
    uid = np.concatenate([
        rng.integers(0, 2**23, 3000),
        [0, 1, 65535, 65536, 2**31 - 1, 2**32 - 1, 0x9E3779B9,
         0xFFFF0000]]).astype(np.int64)
    att = np.concatenate([rng.integers(0, 16, 3000),
                          [0, 1, 2, 3, 32767, 2**31 - 1, 2**32 - 1, 7]])
    return uid, att.astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_crc_hash_matches_reference(seed):
    uid, att = _uids_attempts(np.random.default_rng(seed % 1000))
    want = jretx.crc_hash(seed, uid, att)
    assert want.dtype == np.uint32
    got_np = retx.crc_hash(seed, uid, att)
    assert got_np.dtype == np.uint32
    np.testing.assert_array_equal(got_np, want)
    got_t = retx.crc_hash(torch.tensor(seed, dtype=torch.int64),
                          torch.from_numpy(uid), torch.from_numpy(att))
    assert got_t.dtype == torch.int64
    np.testing.assert_array_equal(got_t.numpy(), want.astype(np.int64))
    # the engine's operand dtypes: int32 uids, int16 attempts, int64 seed
    small = (uid < 2**31) & (att < 2**15)
    got_e = retx.crc_hash(torch.tensor([seed], dtype=torch.int64),
                          torch.from_numpy(uid[small].astype(np.int32)),
                          torch.from_numpy(att[small].astype(np.int16)))
    np.testing.assert_array_equal(got_e.numpy(),
                                  want[small].astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_crc_fail_and_attempts_match_reference(seed):
    rng = np.random.default_rng(seed % 997 + 1)
    uid, att = _uids_attempts(rng)
    perq = rng.integers(0, 2**16, uid.shape).astype(np.int32)
    want = jretx.crc_fail(seed, uid, att, perq)
    np.testing.assert_array_equal(retx.crc_fail(seed, uid, att, perq), want)
    got = retx.crc_fail(torch.tensor(seed, dtype=torch.int64),
                        torch.from_numpy(uid), torch.from_numpy(att),
                        torch.from_numpy(perq))
    np.testing.assert_array_equal(got.numpy(), want)
    for max_retx in (1, 3, 6):
        a_w, d_w = jretx.reference_attempts(seed, uid[:500], perq[:500],
                                            max_retx)
        a_g, d_g = retx.reference_attempts(seed, uid[:500], perq[:500],
                                           max_retx)
        np.testing.assert_array_equal(a_g, a_w)
        np.testing.assert_array_equal(d_g, d_w)


# ---------------------------------------------------------------- pack

_PACK_CASES = {
    "adaptive": (JFabric.WIRELESS, dict(link_budget_db=15.0)),
    "fixed0_seed": (JFabric.WIRELESS, dict(link_budget_db=19.0,
                                          policy="fixed:0",
                                          seed=0xFFFFFFFF)),
    "drift": (JFabric.WIRELESS, dict(link_budget_db=19.0,
                                     drift_amp_db=4.0)),
    "reselect": (JFabric.WIRELESS, dict(link_budget_db=19.0,
                                        reselect=True)),
    "drift_reselect": (JFabric.WIRELESS, dict(drift_amp_db=2.0,
                                              reselect=True,
                                              drift_period=3)),
    "wireline": (JFabric.SUBSTRATE, dict(link_budget_db=10.0)),
}


@pytest.mark.parametrize("name", list(_PACK_CASES))
def test_pack_phy_tables_match_reference(name):
    fab, kw = _PACK_CASES[name]
    sim = dict(cycles=400, warmup=100, seed=0)
    topo_j, topo_t = jbuild(4, 4, fab), tbuild(4, 4, TFabric(int(fab)))
    tt_j = jtraffic.uniform_random(topo_j, 0.3, 0.2, 400, 64, seed=3)
    tt_t = ttraffic.uniform_random(topo_t, 0.3, 0.2, 400, 64, seed=3)
    ps_j = jsim.pack(topo_j, jrouting(topo_j), tt_j, JPHY, JSim(**sim),
                     phy_spec=JSpec(**kw))
    ps_t = tsim.pack(topo_t, trouting(topo_t), tt_t, TPHY, TSim(**sim),
                     phy_spec=TSpec(**kw), device="cpu")
    assert ps_t.flags() == dict(mem_on=ps_j.mem_on, phy_on=ps_j.phy_on,
                                drift_on=ps_j.drift_on,
                                reselect=ps_j.reselect)
    assert ps_j.ss.phy_seed.dtype == np.uint32
    assert ps_t.ss.phy_seed.dtype == torch.int64
    want = np_tree(ps_j.ss)
    got = np_tree(ps_t.ss)
    assert_states_equal(want, got)
    key = dict(ps_t.shape_key()[:5])
    assert key == dict(ps_t.flags(), mc_on=False)
    if fab == JFabric.SUBSTRATE:
        # wireline: the exact pre-PHY program
        assert ps_t.phy_link is None and not ps_t.phy_on
        plain = tsim.pack(topo_t, trouting(topo_t), tt_t, TPHY, TSim(**sim),
                          device="cpu")
        assert plain.shape_key() == ps_t.shape_key()
        assert_states_equal(np_tree(plain.ss), got)
    else:
        pl_t, pl_j = ps_t.phy_link, ps_j.phy_link
        for f in ("rate_idx", "serv", "perq", "epb", "perq_r", "gp_q"):
            np.testing.assert_array_equal(getattr(pl_t, f),
                                          getattr(pl_j, f), err_msg=f)


# ------------------------------------------------------- carried states

_TRACE = Trace("lossy", 8, [
    phase([mcast(0, (2, 3, 4, 5, 6, 7), 2048.0),
           mcast(4, (0, 1, 2, 3), 1024.0)], label="c0:all-reduce"),
    phase([p2p(1, 6, 512.0), p2p(6, 1, 512.0)], label="c1:permute"),
    phase([mcast(2, (0, 6), 512.0), mcast(5, (0, 1, 6, 7), 512.0)],
          label="c2:bcast"),
])


def _lossy_packed(kind):
    topo = jbuild(4, 4, JFabric.WIRELESS)
    rt = jrouting(topo)
    if kind == "unicast":
        tt = jtraffic.uniform_random(topo, 1.0, 0.3, 700, 64, seed=2)
        return jsim.pack(topo, rt, tt, JPHY, JSim(cycles=700, warmup=100),
                         phy_spec=JSpec(link_budget_db=14.0, max_retx=2)), 256
    if kind == "multicast":
        tt = jtraffic.from_trace(topo, _TRACE, JPHY.pkt_flits)
        return jsim.pack(topo, rt, tt, JPHY, JSim(cycles=900, warmup=0),
                         phy_spec=JSpec(link_budget_db=15.0,
                                        max_retx=2)), 128
    # closed-loop memory over the lossy channel (tests/test_phy.py:324)
    tt = jclosed(topo, 0.15, 800, JPHY.pkt_flits,
                 dram=JDram(max_outstanding=4), seed=3)
    return jsim.pack(topo, rt, tt, JPHY, JSim(cycles=1400, warmup=0),
                     phy_spec=JSpec(link_budget_db=14.0, max_retx=2)), 1024


@pytest.mark.parametrize("kind", ["unicast", "multicast", "memory"])
def test_lossy_step_matches_jax_from_carried_state(kind):
    ps, t0 = _lossy_packed(kind)
    assert ps.phy_on and not (ps.drift_on or ps.reselect)
    t1 = ps.sim.cycles
    # the chunked driver: budgets are traced, one compile for both runs
    mid = jsim.run(ps, cycles=t0)
    want = np_tree(jsim.run(ps, cycles=t1))
    got = port_continue([ps], [mid], t0, t1)[0]
    assert_states_equal(want, got, skip=META)
    assert int(want["wl_nacks"]) > int(np.asarray(mid.wl_nacks))
    assert int(want["pkts_dropped"]) > 0
    if kind == "multicast":
        assert int(want["wl_drop_flits"]) > int(want["pkts_dropped"]) \
            * JPHY.pkt_flits                   # counted once per member
    if kind == "memory":
        assert want["dead"].any() and int(want["mem_drop_reads"]) > 0
    # the PHY block of the metrics on the same state
    ps_t = port_packed(ps)
    got.update({k: want[k] for k in META})
    m_t = compute_metrics(ps_t, carry.state_from_numpy(got, "cpu"), "p", 0.0,
                          cycles=t1)
    m_j = jmetrics(ps, jsim.SimState(**want), "p", 0.0, cycles=t1)
    assert_metrics_equal(m_t, m_j)
    assert m_t.wl_nacks > 0 and m_t.energy_breakdown["wl"] > 0


# -------------------------------------------------- host ARQ reference

MAX_RETX = 3


@pytest.fixture(scope="module")
def drained():
    """A lossy point run by the port's chunked driver until it drains."""
    topo = tbuild(4, 4, TFabric.WIRELESS)
    tt = ttraffic.uniform_random(topo, 0.1, 0.3, 900, 64, seed=6)
    ps = tsim.pack(topo, trouting(topo), tt, TPHY,
                   TSim(cycles=4000, warmup=0),
                   phy_spec=TSpec(link_budget_db=16.0, max_retx=MAX_RETX),
                   device="cpu")
    return ps, tsim.run(ps)


def test_attempt_counters_match_host_reference(drained):
    """Engine NACK/drop/crossing totals == the host ARQ prediction once
    the network drains (``tests/test_phy.py``'s property, on the port)."""
    max_retx = MAX_RETX
    ps, st = drained
    assert inflight_flits(st) == 0
    assert int(st.drain_cycle) < ps.sim.cycles      # drained early
    topo, rt = ps.topo, ps.rt
    births = ps.ss.births.numpy()
    dests = ps.ss.dests.numpy()
    src_sw = ps.ss.src_switch.numpy()
    Lw, Wp = topo.n_links, len(topo.wl_pairs)
    nacks = drops = crossings = 0
    for n in range(births.shape[0]):
        for k in range(births.shape[1]):
            if births[n, k] == NO_PKT:
                continue
            cur, dst = int(src_sw[n]), int(dests[n, k])
            for _ in range(64):
                if cur == dst:
                    break
                o = int(rt.next_out[cur, dst])
                if Lw <= o < Lw + Wp:
                    ws, wd = (int(x) for x in topo.wl_pairs[o - Lw])
                    att, deliv = retx.reference_attempts(
                        int(ps.phy_link.spec.seed), n * 65536 + k,
                        int(ps.phy_link.perq[ws, wd]), max_retx)
                    crossings += 1
                    nacks += int(att) - int(deliv)
                    drops += int(~deliv)
                    cur = int(topo.wi_switch[wd])
                else:
                    cur = int(topo.link_dst[o])
    assert crossings > 0 and nacks > 0 and drops > 0
    assert int(st.wl_nacks) == nacks
    assert int(st.pkts_dropped) == drops
    assert int(st.wl_pkts) == crossings - drops
    fail = st.wl_fail_flits.numpy()
    assert (fail % TPHY.pkt_flits == 0).all()
    assert int(fail.sum()) == nacks * TPHY.pkt_flits


def test_packet_conservation_with_drops(drained):
    """Drained: injected == delivered + dropped payload, no phantom."""
    ps, st = drained
    assert inflight_flits(st) == 0
    assert int(st.pkts_dropped) > 0
    assert int(st.flits_inj) == int(st.flits_del) \
        + int(st.pkts_dropped) * TPHY.pkt_flits


# --------------------------------------------------------------- sweeps

def test_phy_sweep_matches_jax():
    """``run_sweep_batched`` over PHY points on two fabrics equals
    the JAX sweep, metric for metric, point names included (the two step
    programs run as two batches)."""
    sim = dict(cycles=300, warmup=100, seed=0)
    grid = [(f, pol) for f in ("WIRELESS", "SUBSTRATE")
            for pol in ("adaptive", "fixed:0")]
    want = jsweep.run_sweep_batched([jsweep.SweepPoint(
        4, 4, JFabric[f], load=0.5, p_mem=0.2, sim=JSim(**sim),
        phy_spec=JSpec(link_budget_db=15.0, policy=pol))
        for f, pol in grid])
    got = tsweep.run_sweep_batched([tsweep.SweepPoint(
        4, 4, TFabric[f], load=0.5, p_mem=0.2, sim=TSim(**sim),
        phy_spec=TSpec(link_budget_db=15.0, policy=pol))
        for f, pol in grid], device="cpu")
    for g, w in zip(got, want):
        assert_metrics_equal(g, w)
    assert got[0].name.endswith("/phy:adaptive@15.0dB")
    assert got[0].wl_pkts > 0 and got[1].wl_nacks > 0
    # wireline: bit-identical across policies, and equal to no phy_spec
    sub = [m for (f, _), m in zip(grid, got) if f == "SUBSTRATE"]
    plain = tsweep.run_point(4, 4, TFabric.SUBSTRATE, load=0.5, p_mem=0.2,
                             sim=TSim(**sim), device="cpu")
    for m in sub:
        assert dataclasses.replace(m, name=plain.name) == plain
