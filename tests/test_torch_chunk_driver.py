"""The port's execution chunk and the sweep's driver choice against the
JAX package.

- ``simulator.run(chunk=)`` at chunks 32, 96 and 256 on the open-loop,
  closed-loop memory (``mem_on``) and living-channel programs: every
  ``SimState`` leaf, ``drain_cycle`` included, equals the reference's
  ``simulator.run(ps, chunk=)`` on the same packed point (exactly, floats
  too, where rel 1e-6 would do).  The living point drains at cycle 288
  under chunk 96 and at 224 under chunk 32, neither a multiple of the
  128-cycle window, so its later boundaries fire in the driver's replay.
  Across chunk sizes every leaf but ``drain_cycle`` is equal;
- ``run_batch(chunk=96)`` with mixed budgets: lanes frozen at their own
  budget or drain while the others step on, each equal to the
  reference's solo run at chunk 96 (a drained living lane replays the
  window boundaries it skipped);
- ``run_sweep_batched(driver="monolithic")`` against the reference's,
  metric for metric, and the port's chunked sweep against it;
- ``sweep.POINTS_RUN`` moves by the same amount in both packages over one
  sequence of ``run_point``, ``latency_sweep`` and ``run_sweep_batched``
  calls.

Small on purpose (4C4M, at most 640 cycles a run): ~40 s on one thread.
"""
import concurrent.futures
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro.core import simulator as jsim  # noqa: E402
from repro.core import sweep as jsweep  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import DEFAULT_PHY, Fabric, SimParams  # noqa: E402
from repro.core.routing import compute_routing  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro.memory import closed_loop_uniform  # noqa: E402
from repro.phy import PhySweepSpec  # noqa: E402
from repro_torch.core import constants as tconst  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from torch_compare import (assert_metrics_equal,  # noqa: E402
                           assert_states_equal, np_tree, port_packed)

CHUNKS = (32, 96, 256)
DRIFT = dict(link_budget_db=26.0, drift_amp_db=4.0, reselect=True)


@pytest.fixture(scope="module")
def system():
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    return topo, compute_routing(topo)


def _point(program: str, system, floors=None):
    """A JAX-packed point of one program.  ``open``: uniform traffic at
    load 0.5 through a 200-cycle budget (mid-chunk for every chunk);
    ``mem_on``: closed-loop requests born in 30 cycles, drained by
    256-288 of a 400-cycle budget; ``living``: a drift point (26 dB, 4 dB
    drift, re-selection) with births in the first 16 cycles, drained by
    224-288 of 640."""
    topo, rt = system
    spec = None
    if program == "open":
        sim = SimParams(cycles=200, warmup=100)
        tt = jtraffic.uniform_random(topo, 0.5, 0.2, 200, 64, seed=5)
    elif program == "mem_on":
        sim = SimParams(cycles=400, warmup=32)
        tt = closed_loop_uniform(topo, 0.2, 30, 64, seed=0)
    else:
        sim = SimParams(cycles=640, warmup=0)
        tt = jtraffic.uniform_random(topo, 0.2, 0.2, 16, 64, seed=0)
        spec = PhySweepSpec(**DRIFT)
    return jsim.pack(topo, rt, tt, DEFAULT_PHY, sim, phy_spec=spec,
                     floors=floors)


@pytest.fixture(scope="module")
def points(system):
    return {p: _point(p, system) for p in ("open", "mem_on", "living")}


@pytest.fixture(scope="module")
def runs(points):
    """Both packages' runs of each program at each chunk, once.  Each JAX
    run compiles a program of its own (the chunk is static there): they
    compile on threads, outside the interpreter lock, while the port runs
    here."""
    keys = [(prog, c) for prog in points for c in CHUNKS]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        want = {k: pool.submit(jsim.run, points[k[0]], chunk=k[1])
                for k in keys}
        got = {k: np_tree(tsim.run(port_packed(points[k[0]]), chunk=k[1]))
               for k in keys}
        return {k: (np_tree(want[k].result()), got[k]) for k in keys}


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("program", ["open", "mem_on", "living"])
def test_run_chunk_matches_jax(program, chunk, runs, points):
    want, got = runs[program, chunk]
    assert_states_equal(want, got)
    budget = points[program].sim.cycles
    assert int(got["cycles_run"]) == budget
    assert int(got["flits_inj"]) > 0
    if program != "open":          # these drain before their budget
        assert int(got["drain_cycle"]) < budget
        assert int(got["drain_cycle"]) % chunk == 0


def test_living_drain_off_the_window_replays(runs):
    """The hard case: under chunk 96 the living point stops at 288 and
    under chunk 32 at 224, both off the 128-cycle window; the boundaries
    from 384 (256) on fire only in the replay, and the re-selection count
    equals that of the run under chunk 256, which stops on the window."""
    drains = {c: int(runs["living", c][1]["drain_cycle"]) for c in CHUNKS}
    assert drains == {32: 224, 96: 288, 256: 256}
    resel = {int(runs["living", c][1]["wl_resel"]) for c in CHUNKS}
    assert len(resel) == 1 and resel.pop() > 0


@pytest.mark.parametrize("program", ["open", "mem_on", "living"])
def test_chunk_size_invariance(program, runs):
    """Across chunks every leaf but ``drain_cycle`` is equal."""
    base = runs[program, CHUNKS[0]][1]
    for c in CHUNKS[1:]:
        assert_states_equal(base, runs[program, c][1], skip=("drain_cycle",))


def test_chunk_must_be_positive(points):
    pt = port_packed(points["open"])
    for bad in (0, -96, 96.0):
        with pytest.raises(ValueError, match="chunk"):
            tsim.run(pt, cycles=8, chunk=bad)


def test_mixed_budget_batch_chunk96_equals_solo_runs(system):
    """Open-loop lanes with budgets 250, 150 and 700 (the last one's
    traffic stops at 60, so it drains) in one ``run_batch(chunk=96)``,
    and a living batch whose first lane drains at 288 of its 640 while
    the second steps through its 352: each lane equals the reference's
    solo run at chunk 96."""
    topo, rt = system
    cases = [(250, 250, 5), (150, 150, 6), (60, 700, 7)]
    tables = [jtraffic.uniform_random(topo, 0.4, 0.2, n, 64, seed=s)
              for n, _, s in cases]
    floors = {k: max(jsim.pack_dims(topo, tt)[k] for tt in tables)
              for k in jsim.pack_dims(topo, tables[0])}
    open_pss = [jsim.pack(topo, rt, tt, DEFAULT_PHY,
                          SimParams(cycles=b, warmup=50), floors=floors)
                for tt, (_, b, _) in zip(tables, cases)]
    late_tt = jtraffic.uniform_random(topo, 0.3, 0.2, 352, 64, seed=1)
    lfloors = jsim.pack_dims(topo, late_tt)
    live_pss = [_point("living", system, floors=lfloors),
                jsim.pack(topo, rt, late_tt, DEFAULT_PHY,
                          SimParams(cycles=352, warmup=0),
                          phy_spec=PhySweepSpec(**DRIFT), floors=lfloors)]
    for pss in (open_pss, live_pss):
        got = np_tree(tsim.run_batch([port_packed(ps) for ps in pss],
                                     chunk=96))
        for g, ps in enumerate(pss):
            want = np_tree(jsim.run(ps, chunk=96))
            assert_states_equal(want, {k: v[g] for k, v in got.items()})
    assert [int(d) for d in got["drain_cycle"]] == [288, 352]


def _sweep(sw, const, driver, **dev):
    return sw.run_sweep_batched(
        [sw.SweepPoint(4, 4, const.Fabric(f), load=0.5, p_mem=0.2,
                       sim=const.SimParams(cycles=64, warmup=32, seed=0))
         for f in (0, 1, 2)], cycles=160, driver=driver, **dev)


def test_sweep_monolithic_matches_jax():
    """A 64-cycle table run to a 160-cycle budget on the three fabrics:
    under ``driver="monolithic"`` every metric equals the reference's,
    and the port's chunked run equals it in every metric but
    ``drain_cycle``."""
    from repro.core import constants as jconst
    want = _sweep(jsweep, jconst, "monolithic")
    got = _sweep(tsweep, tconst, "monolithic", device="cpu")
    for g, w in zip(got, want):
        assert_metrics_equal(g, w)
    assert [m.drain_cycle for m in got] == [160] * 3
    for c, m in zip(_sweep(tsweep, tconst, "chunked", device="cpu"), got):
        assert_metrics_equal(dataclasses.replace(c, drain_cycle=160), m)
    with pytest.raises(ValueError, match="driver"):
        tsweep.run_sweep_batched(
            [tsweep.SweepPoint(4, 4, tconst.Fabric.WIRELESS, load=0.1)],
            cycles=8, driver="scan", device="cpu")


def test_points_run_moves_as_reference():
    """One sequence of calls through each package's sweep entry points
    (the last one is the sweep of the test above, compiled there)."""
    def sequence(sw, const, **dev):
        sim = const.SimParams(cycles=16, warmup=0, seed=0)
        before = sw.POINTS_RUN
        sw.run_point(4, 4, const.Fabric.WIRELESS, 0.3, sim=sim, **dev)
        sw.latency_sweep(4, 4, const.Fabric.WIRELESS, [0.3], sim=sim, **dev)
        _sweep(sw, const, "monolithic", **dev)
        return sw.POINTS_RUN - before

    from repro.core import constants as jconst
    want = sequence(jsweep, jconst)
    assert want == 5
    assert sequence(tsweep, tconst, device="cpu") == want
