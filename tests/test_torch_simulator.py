"""The port's cycle step and drivers against the JAX engine, leaf by leaf.

Both engines start from one state: the JAX package packs each point, and
``repro_torch.carry`` carries its ``SimStatic`` and initial (or mid-run)
``SimState`` into the port.  After a budget that is not a multiple of the
128-cycle chunk, every ``SimState`` leaf must equal the JAX engine's
exactly — name, dtype and value (floats included: the step's only float,
``lat_sum``, sums small integers).  All points are packed onto one shape so
the JAX engine compiles once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import simulator as jsim  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import Fabric, MacMode, PhyParams, SimParams  # noqa: E402
from repro.core.routing import compute_routing  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import sweep as tsweep  # noqa: E402
from repro_torch.core import constants as tconst  # noqa: E402

CYCLES, WARMUP = 300, 100

# (fabric, load, phy overrides, sim overrides, app)
CASES = {
    "wireless_crossbar": (Fabric.WIRELESS, 0.5, {}, {}, None),
    "wireless_matching": (Fabric.WIRELESS, 0.5,
                          dict(wireless_medium="matching"), {}, None),
    "wireless_single": (Fabric.WIRELESS, 0.5,
                        dict(wireless_medium="single",
                             wireless_flit_cycles=5), {}, None),
    "interposer": (Fabric.INTERPOSER, 0.5, {}, {}, None),
    "substrate": (Fabric.SUBSTRATE, 0.5, {}, {}, None),
    "canneal_app": (Fabric.WIRELESS, 1.0, {}, {}, "canneal"),
    "token_mac": (Fabric.WIRELESS, 0.5, {}, dict(mac=MacMode.TOKEN), None),
    "awake_rx": (Fabric.WIRELESS, 0.1, {}, dict(sleepy_rx=False), None),
}
# mixed budgets in one batch: (case, table cycles, budget, warmup); the
# last lane's traffic stops at cycle 100, so it drains before its budget
MIXED = [("wireless_crossbar", 300, 300, 100), ("interposer", 200, 200, 50),
         ("substrate", 430, 430, 100), ("awake_rx", 100, 700, 100)]


def _table(case, table_cycles):
    fabric, load, phy_kw, _, app = CASES[case]
    phy = PhyParams(**phy_kw)
    topo = build_xcym(4, 4, fabric, phy)
    if app:
        tt = jtraffic.application(topo, jtraffic.APP_MODELS[app],
                                  table_cycles, phy.pkt_flits, seed=0,
                                  load_scale=load)
    else:
        tt = jtraffic.uniform_random(topo, load, 0.2, table_cycles,
                                     phy.pkt_flits, seed=0)
    return topo, compute_routing(topo), tt, phy


@pytest.fixture(scope="module")
def floors():
    dims = [jsim.pack_dims(*_table(c, n)[::2])
            for c, n in [(c, CYCLES) for c in CASES]
            + [(c, n) for c, n, _, _ in MIXED]]
    return {k: max(d[k] for d in dims) for k in dims[0]}


def _jax_pack(case, floors, table_cycles=CYCLES, cycles=CYCLES,
              warmup=WARMUP):
    topo, rt, tt, phy = _table(case, table_cycles)
    sim = SimParams(cycles=cycles, warmup=warmup, **CASES[case][3])
    return jsim.pack(topo, rt, tt, phy, sim, floors=floors)


def _np(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def assert_states_equal(want: dict, got: dict, skip=()):
    assert list(got) == list(want)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_runs(floors):
    out = {}
    for case in CASES:
        ps = _jax_pack(case, floors)
        out[case] = (ps, _np(jsim.run(ps)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_from_carried_state(case, jax_runs):
    ps, want = jax_runs[case]
    ss = carry.static_from_numpy(_np(ps.ss), "cpu")
    st0 = carry.state_from_numpy(_np(jsim.init_state(*jsim._state_dims(ps))),
                                 "cpu")
    got = carry.state_to_numpy(tsim.run_from(ss, st0))
    assert_states_equal(want, got)
    assert want["pkts_del"] > 0 or case == "substrate"


@pytest.mark.parametrize("case", ["wireless_single", "interposer"])
def test_continue_from_mid_run_state(case, jax_runs):
    """Both engines continue one carried mid-run state for 150 cycles."""
    ps, _ = jax_runs[case]
    step = jsim.make_step(ps.B)
    scan = jax.jit(lambda ss, st, ts: jax.lax.scan(
        lambda c, t: (step(ss, c, t), None), st, ts)[0])
    st_mid = scan(ps.ss, jsim.init_state(*jsim._state_dims(ps)),
                  jnp.arange(0, 150, dtype=jnp.int32))
    want = _np(scan(ps.ss, st_mid, jnp.arange(150, CYCLES, dtype=jnp.int32)))
    lanes = carry.static_from_numpy(_np(ps.ss), "cpu")
    lanes = tsim.SimStatic(*(x[None] for x in lanes))
    st = carry.state_from_numpy(_np(st_mid), "cpu")
    st = tsim.SimState(*(x[None] for x in st))
    out = tsim.run_cycles(lanes, st, 150, CYCLES, ps.B)
    got = carry.state_to_numpy(tsim.SimState(*(x[0] for x in out)))
    assert_states_equal(want, got)


@pytest.mark.parametrize("case", ["wireless_matching", "substrate"])
def test_monolithic_equals_chunked(case, jax_runs):
    ps, want = jax_runs[case]
    ss = carry.static_from_numpy(_np(ps.ss), "cpu")
    st0 = carry.state_from_numpy(_np(jsim.init_state(*jsim._state_dims(ps))),
                                 "cpu")
    mono = carry.state_to_numpy(tsim.run_from(ss, st0, driver="monolithic"))
    assert_states_equal(want, mono, skip=("drain_cycle",))
    assert int(mono["drain_cycle"]) == CYCLES


def test_mixed_budget_batch_equals_solo_runs(floors):
    pss_j = [_jax_pack(c, floors, n, b, w) for c, n, b, w in MIXED]
    pss_t = []
    for ps in pss_j:
        ps_t = tsim.PackedSim(
            ss=carry.static_from_numpy(_np(ps.ss), "cpu"), B=ps.B,
            n_cores=ps.n_cores, Lw=ps.Lw, n_inj=ps.n_inj, topo=ps.topo,
            rt=ps.rt, phy=ps.phy, sim=ps.sim, dims=ps.dims)
        pss_t.append(ps_t)
    out = carry.state_to_numpy(tsim.run_batch(pss_t))
    for g, ps in enumerate(pss_j):
        want = _np(jsim.run(ps))
        assert_states_equal(want, {k: v[g] for k, v in out.items()})
    # lanes really stopped at their own points
    assert list(out["cycles_run"]) == [b for _, _, b, _ in MIXED]
    assert out["drain_cycle"][-1] < MIXED[-1][2]


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.init_state(64, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsweep.run_point(4, 4, tconst.Fabric.WIRELESS, load=0.2,
                         sim=tconst.SimParams(cycles=200, warmup=50))


def test_unported_step_paths_raise():
    """Every step program is ported; the one combination the reference
    refuses still raises: a living channel without the ARQ path."""
    for flag in ("drift_on", "reselect"):
        with pytest.raises(AssertionError, match="ARQ path"):
            tsim.make_step(64, **{flag: True})
        assert callable(tsim.make_step(64, phy_on=True, **{flag: True}))
    assert callable(tsim.make_step(64, phy_on=True))
