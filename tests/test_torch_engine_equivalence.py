"""The port's scatter engine (``repro_torch.core.simulator_ref``) against
the port's gather engine and against the JAX ``simulator_ref``.

- The cases of ``tests/test_engine_equivalence.py`` (the same test names,
  traffic and PHY settings, cut to ``CYCLES`` cycles) through the port's
  two engines: every state leaf bitwise equal (name, dtype, shape, value)
  except the engines' own encodings (``out_wo``; ``mc_src``/``src_of``).
- Each step program (open loop, ``mem_on``, multicast, ``phy_on``,
  living) through the port's scatter engine and the JAX ``simulator_ref``
  on the same packed inputs (the JAX package packs; the port runs its
  tables): every leaf bitwise equal.
- Chunked against monolithic on the scatter engine, as
  ``tests/test_chunked_exec.py::test_chunked_equals_monolithic_ref_engine``
  does for the reference.
- The CUDA hazards the engine handles by construction: every ``.set``
  scatter writes each in-range target at most once a cycle (or one value
  to all of them), asserted on every program; an out-of-range masked
  write leaves the table as JAX's ``mode="drop"`` does; the float32
  scatter-adds stay below 2^24 at fig8's sizes, so their order is free.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simulator_ref as jref  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import (DEFAULT_PHY, Fabric, MacMode,  # noqa: E402
                                  PhyParams, SimParams)
from repro.core.routing import compute_routing  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro.workloads.trace import Trace, mcast, p2p, phase  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import simulator_ref as tref  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core import constants as tconst  # noqa: E402
from repro_torch.core.routing import compute_routing as t_routing  # noqa: E402
from repro_torch.core.topology import build_xcym as t_build  # noqa: E402
from repro_torch.workloads import trace as ttrace  # noqa: E402
from torch_compare import assert_states_equal, np_tree  # noqa: E402

CYCLES = 256
ARQ_CYCLES = 640      # multicast over the lossy channel: a group's ARQ
SKIP = {"out_wo", "mc_src"}
FIXTURES = pathlib.Path(__file__).parent / "torch_fixtures"


def _t(enum_or_params):
    """A JAX-side constant as the port's (same fields and values)."""
    import dataclasses
    if isinstance(enum_or_params, Fabric):
        return tconst.Fabric(int(enum_or_params))
    if isinstance(enum_or_params, MacMode):
        return tconst.MacMode(int(enum_or_params))
    cls = getattr(tconst, type(enum_or_params).__name__)
    kw = {f.name: _t(getattr(enum_or_params, f.name))
          if isinstance(getattr(enum_or_params, f.name), (Fabric, MacMode))
          else getattr(enum_or_params, f.name)
          for f in dataclasses.fields(enum_or_params)}
    return cls(**kw)


def _compare(topo_args, tt_fn, phy=DEFAULT_PHY, sim=None, spec=None):
    """Run one point through the port's two engines on the CPU; every
    leaf but the engines' own encodings must be equal.  ``topo_args``
    are ``build_xcym``'s (n_chips, n_mem, fabric); ``tt_fn(topo)`` makes
    the port's traffic table."""
    n_chips, n_mem, fabric = topo_args
    tphy = _t(phy)
    topo = t_build(n_chips, n_mem, _t(fabric), tphy)
    rt = t_routing(topo)
    tt = tt_fn(topo)
    tsim_params = _t(sim)
    sr = tref.run(tref.pack(topo, rt, tt, tphy, tsim_params,
                            phy_spec=spec, device="cpu"))
    sg = tsim.run(tsim.pack(topo, rt, tt, tphy, tsim_params, phy_spec=spec,
                            device="cpu"))
    a, b = np_tree(sr), np_tree(sg)
    for f in a:
        if f in SKIP:
            continue
        assert f in b, f
        assert a[f].dtype == b[f].dtype and a[f].shape == b[f].shape, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert int(sg.flits_inj) > 0
    return sg


def _uniform(load, p_mem, cycles, flits, seed):
    return lambda topo: ttraffic.uniform_random(topo, load, p_mem, cycles,
                                                flits, seed=seed)


# ---- the cases of tests/test_engine_equivalence.py, port against port

def test_engines_equivalent_wireless():
    sim = SimParams(cycles=CYCLES, warmup=100)
    _compare((4, 4, Fabric.WIRELESS), _uniform(0.7, 0.3, CYCLES, 64, 11),
             sim=sim)


@pytest.mark.parametrize("fabric", [Fabric.INTERPOSER, Fabric.SUBSTRATE])
def test_engines_equivalent_wired(fabric):
    sim = SimParams(cycles=CYCLES, warmup=0)
    _compare((4, 4, fabric), _uniform(0.9, 0.2, CYCLES, 64, 5), sim=sim)


def _variant(case, cycles=CYCLES):
    phy, sim = DEFAULT_PHY, SimParams(cycles=cycles, warmup=0)
    if case == "matching":
        phy = PhyParams(wireless_medium="matching")
    elif case == "single":
        phy = PhyParams(wireless_medium="single", wireless_flit_cycles=5)
    else:
        sim = SimParams(cycles=cycles, warmup=0, mac=MacMode.TOKEN)
    return phy, sim


@pytest.mark.parametrize("case", ["matching", "single", "token"])
def test_engines_equivalent_wireless_variants(case):
    phy, sim = _variant(case)
    _compare((4, 4, Fabric.WIRELESS),
             _uniform(0.8, 0.3, CYCLES, phy.pkt_flits, 7), phy, sim)


_MC_TRACE = Trace("eq", 8, [
    phase([mcast(0, (2, 3, 4, 5, 6, 7), 2048.0),
           mcast(4, (0, 1, 2, 3), 1024.0)], label="c0:all-reduce"),
    phase([p2p(1, 6, 512.0), p2p(6, 1, 512.0)], label="c1:permute"),
    phase([mcast(2, (0, 6), 512.0), mcast(5, (0, 1, 6, 7), 512.0)],
          label="c2:bcast"),
])
_T_MC_TRACE = ttrace.Trace("eq", 8, [
    ttrace.phase([ttrace.mcast(0, (2, 3, 4, 5, 6, 7), 2048.0),
                  ttrace.mcast(4, (0, 1, 2, 3), 1024.0)],
                 label="c0:all-reduce"),
    ttrace.phase([ttrace.p2p(1, 6, 512.0), ttrace.p2p(6, 1, 512.0)],
                 label="c1:permute"),
    ttrace.phase([ttrace.mcast(2, (0, 6), 512.0),
                  ttrace.mcast(5, (0, 1, 6, 7), 512.0)], label="c2:bcast"),
])


def _mc(phy):
    return lambda topo: ttraffic.from_trace(topo, _T_MC_TRACE,
                                            phy.pkt_flits)


@pytest.mark.parametrize("medium", ["crossbar", "single"])
def test_engines_equivalent_multicast_trace(medium):
    phy = PhyParams(wireless_medium=medium,
                    wireless_flit_cycles=5 if medium == "single" else 1)
    sim = SimParams(cycles=CYCLES, warmup=0)
    _compare((4, 4, Fabric.WIRELESS), _mc(phy), phy, sim)


@pytest.mark.parametrize("case", ["matching", "wired", "8c"])
def test_engines_equivalent_multicast_variants(case):
    phy = DEFAULT_PHY
    if case == "8c":
        topo_args = (8, 4, Fabric.WIRELESS)
    elif case == "wired":
        topo_args = (4, 4, Fabric.INTERPOSER)        # expanded unicasts
    else:
        topo_args = (4, 4, Fabric.WIRELESS)
        phy = PhyParams(wireless_medium="matching")
    _compare(topo_args, _mc(phy), phy, SimParams(cycles=CYCLES, warmup=0))


def _closed_loop(cycles, phy=DEFAULT_PHY, seed=17):
    from repro_torch.memory import DramTimingParams, closed_loop_uniform
    return lambda topo: closed_loop_uniform(
        topo, 0.5, cycles, phy.pkt_flits,
        dram=DramTimingParams(max_outstanding=4), seed=seed)


def test_engines_equivalent_closed_loop_memory():
    sim = SimParams(cycles=CYCLES, warmup=100)
    _compare((4, 4, Fabric.WIRELESS), _closed_loop(CYCLES), sim=sim)


def _lossy_spec(budget=17.0, policy="adaptive"):
    from repro_torch.phy import PhySweepSpec
    return PhySweepSpec(link_budget_db=budget, policy=policy, max_retx=3)


def test_engines_equivalent_lossy_crossbar():
    sim = SimParams(cycles=CYCLES, warmup=100)
    sg = _compare((4, 4, Fabric.WIRELESS), _uniform(0.6, 0.3, CYCLES, 64, 21),
                  sim=sim, spec=_lossy_spec())
    assert int(sg.wl_nacks) > 0       # the point exercised the ARQ path


@pytest.mark.parametrize("case", ["matching", "single", "token"])
def test_engines_equivalent_lossy_media(case):
    phy, sim = _variant(case)
    _compare((4, 4, Fabric.WIRELESS),
             _uniform(0.7, 0.3, CYCLES, phy.pkt_flits, 23), phy, sim,
             _lossy_spec(budget=16.0))


@pytest.mark.parametrize("case", ["fixed-fast", "drops", "8c", "memcl"])
def test_engines_equivalent_lossy_variants(case):
    from repro_torch.phy import PhySweepSpec
    sim = SimParams(cycles=CYCLES, warmup=0)
    spec = _lossy_spec()
    topo_args = (8 if case == "8c" else 4, 4, Fabric.WIRELESS)
    if case == "fixed-fast":
        spec = _lossy_spec(budget=15.0, policy="fixed:0")
    elif case in ("drops", "memcl"):
        spec = PhySweepSpec(link_budget_db=13.0, max_retx=2)
    if case == "memcl":
        # drop-heavy: the outstanding credit and reply tombstones
        sg = _compare(topo_args, _closed_loop(CYCLES), sim=sim, spec=spec)
        assert int(sg.pkts_dropped) > 0 and bool(sg.dead.any())
        return
    sg = _compare(topo_args, _uniform(0.6, 0.3, CYCLES, 64, 29), sim=sim,
                  spec=spec)
    if case == "drops":
        assert int(sg.pkts_dropped) > 0


@pytest.mark.parametrize("case", ["single", "token", "wired", "8c"])
def test_engines_equivalent_closed_loop_variants(case):
    phy, sim = DEFAULT_PHY, SimParams(cycles=CYCLES, warmup=0)
    if case == "8c":
        topo_args = (8, 4, Fabric.WIRELESS)
    elif case == "wired":
        topo_args = (4, 4, Fabric.INTERPOSER)
    else:
        topo_args = (4, 4, Fabric.WIRELESS)
        phy, sim = _variant(case)
    _compare(topo_args, _closed_loop(CYCLES, phy), phy, sim)


def test_engines_equivalent_broadcast_arq():
    # the groups' first NACK comes after CYCLES: run ARQ_CYCLES
    sg = _compare((4, 4, Fabric.WIRELESS), _mc(DEFAULT_PHY),
                  sim=SimParams(cycles=ARQ_CYCLES, warmup=0),
                  spec=_lossy_spec())
    assert int(sg.wl_nacks) > 0       # a group actually retransmitted


@pytest.mark.parametrize("case", ["token", "8c", "drop-heavy", "living"])
def test_engines_equivalent_broadcast_arq_variants(case):
    from repro_torch.phy import PhySweepSpec
    sim = SimParams(cycles=CYCLES, warmup=0)
    spec = _lossy_spec()
    topo_args = (8 if case == "8c" else 4, 4, Fabric.WIRELESS)
    if case == "token":
        sim = SimParams(cycles=CYCLES, warmup=0, mac=MacMode.TOKEN)
    elif case == "drop-heavy":
        spec = PhySweepSpec(link_budget_db=13.0, max_retx=2)
        sim = SimParams(cycles=ARQ_CYCLES, warmup=0)
    elif case == "living":
        spec = PhySweepSpec(link_budget_db=17.0, max_retx=3,
                            drift_amp_db=4.0, reselect=True)
    sg = _compare(topo_args, _mc(DEFAULT_PHY), sim=sim, spec=spec)
    if case == "drop-heavy":
        assert int(sg.pkts_dropped) > 0 and int(sg.wl_drop_flits) > 0


def test_engines_equivalent_living_uniform():
    from repro_torch.phy import PhySweepSpec
    spec = PhySweepSpec(link_budget_db=17.0, max_retx=3, drift_amp_db=4.0,
                        reselect=True)
    sg = _compare((4, 4, Fabric.WIRELESS), _uniform(0.6, 0.3, CYCLES, 64, 31),
                  sim=SimParams(cycles=CYCLES, warmup=0), spec=spec)
    assert int(sg.wl_resel) > 0       # the channel actually moved


# ---- each step program: the port's scatter engine against JAX's

def _jax_point(program: str):
    """A JAX-packed ``simulator_ref`` point of one step program."""
    from repro.memory import DramTimingParams, closed_loop_uniform
    from repro.phy import PhySweepSpec
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    sim = SimParams(cycles=CYCLES, warmup=50)
    spec = None
    if program == "mem_on":
        tt = closed_loop_uniform(topo, 0.5, CYCLES, 64,
                                 dram=DramTimingParams(max_outstanding=4),
                                 seed=17)
    elif program == "multicast":
        tt = jtraffic.from_trace(topo, _MC_TRACE, 64)
    else:
        tt = jtraffic.uniform_random(topo, 0.6, 0.3, CYCLES, 64, seed=21)
        if program == "phy_on":
            spec = PhySweepSpec(link_budget_db=13.0, max_retx=2)
        elif program == "living":
            spec = PhySweepSpec(link_budget_db=17.0, max_retx=3,
                                drift_amp_db=4.0, reselect=True)
    return jref.pack(topo, compute_routing(topo), tt, DEFAULT_PHY, sim,
                     phy_spec=spec)


def port_packed_ref(ps):
    """A JAX ``simulator_ref.PackedSim`` as the port's (tables on the
    CPU)."""
    ss = tref.SimStatic(**{k: torch.from_numpy(np.array(v))
                           for k, v in np_tree(ps.ss).items()})
    return tref.PackedSim(
        ss=ss, B=ps.B, Wout=ps.Wout, n_cores=ps.n_cores, Lw=ps.Lw,
        n_inj=ps.n_inj, topo=ps.topo, rt=ps.rt, phy=ps.phy, sim=ps.sim,
        RXW=ps.RXW, mem_on=ps.mem_on, Y=ps.Y, BK=ps.BK, phy_on=ps.phy_on,
        drift_on=ps.drift_on, reselect=ps.reselect, phy_link=ps.phy_link)


PROGRAMS = ["open_loop", "mem_on", "multicast", "phy_on", "living"]


@pytest.fixture(params=PROGRAMS)
def program(request):
    return request.param


def test_scatter_engine_matches_jax_simulator_ref(program):
    ps = _jax_point(program)
    assert ps.mem_on == (program == "mem_on")
    assert ps.phy_on == (program in ("phy_on", "living"))
    assert (ps.drift_on and ps.reselect) == (program == "living")
    want = np_tree(jref.run(ps))
    got = np_tree(tref.run(port_packed_ref(ps)))
    assert_states_equal(want, got)
    assert int(want["flits_inj"]) > 0
    if program == "phy_on":
        assert int(want["pkts_dropped"]) > 0
    if program == "living":
        assert int(want["wl_resel"]) > 0


def test_scatter_engine_jax_packs_equal_port_packs():
    """The port's own ``pack`` gives the JAX ``pack``'s tables."""
    for program in PROGRAMS:
        ps = _jax_point(program)
        phy, sim = ps.phy, ps.sim
        topo = t_build(4, 4, tconst.Fabric.WIRELESS)
        rt = t_routing(topo)
        if program == "mem_on":
            tt = _closed_loop(CYCLES)(topo)
        elif program == "multicast":
            tt = ttraffic.from_trace(topo, _T_MC_TRACE, 64)
        else:
            tt = ttraffic.uniform_random(topo, 0.6, 0.3, CYCLES, 64, seed=21)
        spec = None
        if ps.phy_on:
            from repro_torch.phy import PhySweepSpec
            spec = PhySweepSpec(link_budget_db=13.0, max_retx=2) \
                if program == "phy_on" else PhySweepSpec(
                    link_budget_db=17.0, max_retx=3, drift_amp_db=4.0,
                    reselect=True)
        pt = tref.pack(topo, rt, tt, _t(phy), _t(sim), phy_spec=spec,
                       device="cpu")
        assert (pt.B, pt.Wout, pt.RXW, pt.Y, pt.BK) == \
            (ps.B, ps.Wout, ps.RXW, ps.Y, ps.BK)
        assert pt.flags() == dict(mem_on=ps.mem_on, phy_on=ps.phy_on,
                                  drift_on=ps.drift_on,
                                  reselect=ps.reselect)
        assert_states_equal(np_tree(ps.ss), np_tree(pt.ss))


# ---- chunked against monolithic on the scatter engine

def _drain_point(case: str):
    """(topo, rt, tt, phy, sim) of a chunked-driver case: a budget that
    ends mid-chunk, and two points that drain well before their budget."""
    phy = tconst.DEFAULT_PHY
    topo = t_build(4, 4, tconst.Fabric.WIRELESS)
    if case == "mem_on":
        from repro_torch.memory import closed_loop_uniform
        sim = tconst.SimParams(cycles=512, warmup=50)
        tt = closed_loop_uniform(topo, 0.2, 60, phy.pkt_flits, seed=2)
    elif case == "trace":
        sim = tconst.SimParams(cycles=640, warmup=0)
        tt = ttraffic.from_trace(topo, ttrace.Trace("drain", 8, [
            ttrace.phase([ttrace.mcast(0, (2, 3, 4, 5), 512.0),
                          ttrace.p2p(1, 6, 256.0)], label="a")]),
            phy.pkt_flits)
    else:
        sim = tconst.SimParams(cycles=CYCLES, warmup=100)
        tt = ttraffic.uniform_random(topo, 0.5, 0.2, sim.cycles,
                                     phy.pkt_flits, seed=1)
    return topo, t_routing(topo), tt, phy, sim


@pytest.mark.parametrize("case", ["crossbar", "mem_on", "trace"])
def test_chunked_equals_monolithic_scatter_engine(case):
    """The scatter engine shares the chunk driver and agrees bitwise with
    its monolithic run, and with the gather engine, drain metadata
    included."""
    topo, rt, tt, phy, sim = _drain_point(case)
    pr = tref.pack(topo, rt, tt, phy, sim, device="cpu")
    a = np_tree(tref.run(pr))
    b = np_tree(tref.run(pr, driver="monolithic"))
    assert_states_equal(b, a, skip={"drain_cycle"})
    assert int(b["drain_cycle"]) == sim.cycles
    assert int(a["cycles_run"]) == sim.cycles
    if case != "crossbar":
        assert int(a["drain_cycle"]) < sim.cycles     # the predicate fired
    g = np_tree(tsim.run(tsim.pack(topo, rt, tt, phy, sim, device="cpu")))
    for f in a:
        if f not in SKIP:
            np.testing.assert_array_equal(a[f], g[f], err_msg=f)


# ---- the CUDA hazards, on the CPU

def test_set_scatters_have_unique_targets(program, monkeypatch):
    """Every ``.set`` of the step writes each in-range target at most once
    a cycle, or the same value to all its writers: on CUDA the winner
    among duplicate targets is arbitrary."""
    real = tref._put
    seen = {"set": 0}

    def put(a, ix, val, how):
        if how == "set":
            G = a.shape[0]
            n = a[0].numel()
            ixf = ix.reshape(G, -1)
            v = torch.broadcast_to(torch.as_tensor(val, dtype=a.dtype),
                                   ix.shape).reshape(G, -1)
            for g in range(G):
                keep = ixf[g] < n
                t, w = ixf[g][keep].tolist(), v[g][keep].tolist()
                first = {}
                for ti, wi in zip(t, w):
                    assert first.setdefault(ti, wi) == wi, \
                        f"target {ti} written {first[ti]} and {wi}"
                seen["set"] += len(t)
        return real(a, ix, val, how)

    monkeypatch.setattr(tref, "_put", put)
    ps = port_packed_ref(_jax_point(program))
    tref.run(ps, cycles=160)
    assert seen["set"] > 0


def test_masked_writes_drop_as_jax_does():
    """Out-of-range and negative targets through ``_index``/``_put``
    against JAX's ``.at[].set/add/min(..., mode="drop")``."""
    rng = np.random.default_rng(0)
    base = rng.integers(-50, 50, (3, 4, 5)).astype(np.int32)
    for trial in range(20):
        i = rng.integers(-5, 6, (3, 7))      # -5..5 over a dim of 4
        j = rng.integers(-6, 8, (3, 7))      # -6..7 over a dim of 5
        val = rng.integers(-9, 9, (3, 7)).astype(np.int32)
        for how in ("set", "add", "min"):
            want = []
            for g in range(3):
                at = jnp.asarray(base[g]).at[i[g], j[g]]
                want.append(np.asarray(getattr(at, how)(val[g],
                                                        mode="drop")))
            ix = tref._index((4, 5), (torch.from_numpy(i),
                                      torch.from_numpy(j)))
            got = tref._put(torch.from_numpy(base), ix,
                            torch.from_numpy(val), how).numpy()
            if how == "set":
                # duplicates: compare only targets written once
                for g in range(3):
                    w = np.asarray(want[g])
                    tg = [(a % 4, b % 5) for a, b in zip(i[g], j[g])
                          if -4 <= a < 4 and -5 <= b < 5]
                    once = {t for t in tg if tg.count(t) == 1}
                    for r in range(4):
                        for c in range(5):
                            if (r, c) in once or (r, c) not in tg:
                                assert got[g, r, c] == w[r, c]
            else:
                np.testing.assert_array_equal(got, np.stack(want))


def test_segment_min_matches_jax():
    """``_segment_min`` is ``jax.ops.segment_min``: the dtype's maximum
    for an empty segment, ids out of range dropped."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 100, (2, 30)).astype(np.int32)
    ids = rng.integers(-3, 12, (2, 30)).astype(np.int32)
    got = tref._segment_min(torch.from_numpy(data), torch.from_numpy(ids),
                            9).numpy()
    for g in range(2):
        want = np.asarray(jax.ops.segment_min(jnp.asarray(data[g]),
                                              jnp.asarray(ids[g]),
                                              num_segments=9))
        np.testing.assert_array_equal(got[g], want)


def test_float_scatter_adds_stay_exact_at_fig8_sizes():
    """``mem_q_sum``/``mem_svc_sum`` sum integer-valued float32 addends by
    scatter-add, atomics on CUDA: exact, so in any order, while every
    partial sum is below 2^24.  Over fig8's grid at paper width the
    all-stack totals (average per request x requests), which bound every
    stack's partial sums, are far below it."""
    fx = json.loads((FIXTURES / "fig8_reference.json").read_text())
    top = 0.0
    for p in fx["points"]:
        m = p["metrics"]
        n = sum(s["reads"] + s["writes"] for s in m["per_stack"])
        top = max(top, m["mem_queue_cycles"] * n,
                  m["mem_service_cycles"] * n)
    assert 0 < top < 2.0 ** 24 / 16, top
