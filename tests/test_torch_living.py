"""The port's living channel (SNR drift walk, in-scan rate re-selection,
the window replay of the chunked driver) and the drop credit of lossy
traces against the JAX package; mirrors ``tests/test_living_channel.py``.

- ``drift_unit`` and the float32 arithmetic of the drifted tables
  (``phy.xla_f32``) equal the reference's compiled forms; every window
  update of fig9's drift points (19 dB, amplitudes 2/4/6 dB, with and
  without re-selection, 47 windows of 128 cycles) equals the reference's
  jitted ``make_window_fn`` entry for entry, and the drifted tables of
  ``tests/torch_fixtures/fig9_reference.json`` (written by the JAX
  package) equal the port's;
- re-selection is a bitwise no-op on a static channel;
- the step with drift (and re-selection) continues carried JAX states to
  equal every ``SimState`` leaf;
- the chunked driver: a living lane that drains early, batched with one
  that does not, replays the window boundaries it skipped and equals the
  JAX engine (whose chunked run equals its monolithic one); skipping the
  replay leaves the tables and ``wl_resel`` behind;
- a drop-heavy multicast trace closes every phase on drop credits and
  drains early, equal to the JAX engine;
- the fixture's wireless fig9 values equal ``BENCH_fig9_phy.json``.
"""
import base64
import json
import pathlib
import zlib

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
from repro.core.constants import DEFAULT_PHY as JPHY  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import SimParams as JSim  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro.phy import PhySweepSpec as JSpec  # noqa: E402
from repro.phy import living as jliving  # noqa: E402
from repro.phy.rates import GP_SCALE  # noqa: E402
from repro.workloads.trace import Trace, mcast, p2p, phase  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import chunked  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.phy import living  # noqa: E402
from repro_torch.phy import xla_f32  # noqa: E402
from torch_compare import (assert_states_equal, np_tree,  # noqa: E402
                           port_continue, port_packed)

FIXTURES = pathlib.Path(__file__).parent / "torch_fixtures"
META = ("cycles_run", "drain_cycle")
WINDOWS = -(-6000 // 128)          # fig9's budget: windows 0 .. 46
f32 = jnp.float32


def _lanes(ps):
    """A JAX-packed point as the port's one-lane tables and zero state."""
    ss = carry.static_from_numpy(np_tree(ps.ss), "cpu")
    st = carry.state_from_numpy(np_tree(jsim.init_state(
        *jsim._state_dims(ps), mem_on=ps.mem_on, phy_on=ps.phy_on,
        living=ps.drift_on or ps.reselect,
        R=int(ps.ss.wl_serv_r.shape[0]))), "cpu")
    return (tsim.SimStatic(*(x[None] for x in ss)),
            tsim.SimState(*(x[None] for x in st)))


def _fig9_drift_point(amp, reselect, cycles=6000):
    topo = jbuild(4, 4, JFabric.WIRELESS)
    tt = jtraffic.uniform_random(topo, 0.5, 0.2, 128, 64, seed=0)
    return jsim.pack(topo, jrouting(topo), tt, JPHY,
                     JSim(cycles=cycles, warmup=1000),
                     phy_spec=JSpec(link_budget_db=19.0, drift_amp_db=amp,
                                    reselect=reselect))


# ------------------------------------------------------ float32 arithmetic

@pytest.mark.parametrize("seed,win,period", [
    (2, 0, 8), (2, 5, 8), (2, 12, 8), (0, 46, 8), (0xFFFFFFFF, 1000, 3),
    (0x80000000, 7, 1)])
def test_drift_unit_matches_jitted_reference(seed, win, period):
    want = np.asarray(jax.jit(jliving.drift_unit)(
        jnp.uint32(seed), jnp.int32(win), jnp.int32(period)))
    got = living.drift_unit(seed, win, period).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all() and (got == got.T).all()


def _per_ref(p, gain, bits):
    gamma = p * gain
    ber = f32(0.5) * jnp.exp(-gamma / 2)
    return -jnp.expm1(bits * jnp.log1p(-jnp.minimum(ber, f32(0.999999))))


@pytest.mark.parametrize("fn", ["exp", "powf10", "per"])
def test_xla_f32_matches_compiled_reference(fn):
    """The emulated float32 functions equal XLA:CPU's compiled ones on
    300 000 inputs each (the per chain fused as in the window update)."""
    rng = np.random.default_rng(7)
    if fn == "exp":
        x = np.concatenate([rng.uniform(-90, 90, 100000),
                            rng.uniform(-1, 1, 100000),
                            rng.uniform(-30, 0, 100000)]).astype(np.float32)
        want = np.asarray(jax.jit(jnp.exp)(x))
        got = xla_f32.exp_f32(torch.from_numpy(x)).numpy()
    elif fn == "powf10":
        x = rng.uniform(-4, 5, 300000).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.power(f32(10.0), v))(x))
        got = xla_f32.powf10(torch.from_numpy(x)).numpy()
    else:
        x = (10 ** rng.uniform(-1, 3.5, 100000)).astype(np.float32)
        want, got = [], []
        for gain in (1.0, 2.0, 4.0):
            want.append(np.asarray(jax.jit(_per_ref)(x, f32(gain),
                                                     f32(2048.0))))
            got.append(xla_f32.per_chain(torch.from_numpy(x),
                                         torch.tensor(gain),
                                         torch.tensor(2048.0)).numpy())
        want, got = np.concatenate(want), np.concatenate(got)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reselect", [False, True])
@pytest.mark.parametrize("amp", [2.0, 4.0, 6.0])
def test_window_updates_match_jax_on_fig9_drift_windows(amp, reselect):
    """Every window of a fig9 drift point: rate, service, PER threshold
    and the re-selection count equal the reference's jitted update."""
    ps = _fig9_drift_point(amp, reselect)
    fn_j = jax.jit(lambda s, t: jliving.make_window_fn(
        ps.ss, True, reselect)(s, t))
    st_j = jsim.init_state(*jsim._state_dims(ps), phy_on=True, living=True,
                           R=3)
    ss_t, st_t = _lanes(ps)
    fn_t = living.make_window_fn(ss_t, True, reselect)
    for win in range(WINDOWS):
        st_j = fn_j(st_j, jnp.int32(win * 128))
        st_t = fn_t(st_t, win * 128)
        for k in ("wl_rate_d", "wl_serv_d", "wl_perq_d", "wl_resel"):
            np.testing.assert_array_equal(getattr(st_t, k)[0].numpy(),
                                          np.asarray(getattr(st_j, k)),
                                          err_msg=f"window {win} {k}")
    if reselect:
        assert int(st_t.wl_resel[0]) > 0


def _unpack(rec, key, shape):
    raw = zlib.decompress(base64.b64decode(rec[key]))
    return np.frombuffer(raw, "<i4").reshape(shape)


def test_drift_tables_match_fixture():
    """The fixture's drifted PER thresholds (every entry, every window) and
    re-selected rates, from the JAX package's compiled update."""
    fx = json.loads((FIXTURES / "fig9_reference.json").read_text())
    for amp_s, rec in fx["windows"].items():
        n, W = rec["n_wi"], rec["windows"]
        assert W == WINDOWS
        ss, _ = _lanes(_fig9_drift_point(float(amp_s), True))
        R = ss.wl_serv_r.shape[1]
        want_q = _unpack(rec, "perq_r", (W, R, n, n))
        want_r = _unpack(rec, "rate", (W, n, n))
        for win in range(W):
            perq_r, gp_q = living.entry_tables(ss, win)
            np.testing.assert_array_equal(perq_r[0, :, :n, :n].numpy(),
                                          want_q[win], err_msg=str(win))
            np.testing.assert_array_equal(
                living.first_argmax(gp_q, 1)[0, :n, :n].numpy(),
                want_r[win], err_msg=str(win))
            assert (gp_q[0, :, :n, :n] <= 16 * GP_SCALE).all()


# ----------------------------------------------------------------- engine

def test_reselect_is_bitwise_noop_on_static_channel():
    """No drift: the window argmax re-derives the host pick from the same
    integers, so every leaf the two programs share is equal."""
    topo = jbuild(4, 4, JFabric.WIRELESS)
    rt = jrouting(topo)
    tt = jtraffic.uniform_random(topo, 0.6, 0.3, 600, 64, seed=21)
    base = dict(link_budget_db=17.0, max_retx=3)
    pss = [port_packed(jsim.pack(topo, rt, tt, JPHY,
                                 JSim(cycles=600, warmup=0),
                                 phy_spec=JSpec(reselect=r, **base)))
           for r in (False, True)]
    assert [ps.reselect for ps in pss] == [False, True]
    a, b = (np_tree(tsim.run(ps)) for ps in pss)
    assert int(b["wl_resel"]) == 0
    assert int(b["flits_inj"]) > 0 and int(b["wl_nacks"]) > 0
    for k in a:
        if a[k].shape == b[k].shape:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("reselect", [True, False])
def test_living_step_matches_jax_from_carried_state(reselect):
    topo = jbuild(4, 4, JFabric.WIRELESS)
    tt = jtraffic.uniform_random(topo, 0.6, 0.3, 1280, 64, seed=21)
    ps = jsim.pack(topo, jrouting(topo), tt, JPHY,
                   JSim(cycles=1280, warmup=0),
                   phy_spec=JSpec(link_budget_db=17.0, max_retx=3,
                                  drift_amp_db=6.0, reselect=reselect,
                                  drift_period=2))
    assert ps.drift_on and ps.reselect == reselect
    mid = jsim.run(ps, cycles=384)
    want = np_tree(jsim.run(ps))
    got = port_continue([ps], [mid], 384, 1280)[0]
    assert_states_equal(want, got, skip=META)
    assert int(want["wl_nacks"]) > 0
    assert (int(want["wl_resel"]) > 0) == reselect


def _replay_packed(cycles, floors=None):
    """fig9's replay point: births within 256 cycles, drift 4 dB with
    re-selection; it drains at cycle 1024."""
    c = json.loads((FIXTURES / "fig9_reference.json").read_text())[
        "replay"]["case"]
    topo = jbuild(4, 4, JFabric.WIRELESS)
    tt = jtraffic.uniform_random(topo, c["load"], c["p_mem"],
                                 c["birth_cycles"], JPHY.pkt_flits,
                                 seed=c["traffic_seed"])
    return jsim.pack(topo, jrouting(topo), tt, JPHY,
                     JSim(cycles=cycles, warmup=c["warmup"]),
                     phy_spec=JSpec(link_budget_db=c["budget_db"],
                                    drift_amp_db=c["drift_amp_db"],
                                    reselect=c["reselect"], seed=c["seed"]),
                     floors=floors)


def test_chunked_replays_windows_of_drained_lane(monkeypatch):
    """Two lanes in lockstep: the short-birth lane drains at 1024 and is
    frozen while the other (more traffic, same program) keeps stepping;
    the replay brings the drained lane's tables and ``wl_resel`` to what
    JAX's chunked and monolithic runs give."""
    early = _replay_packed(2048)
    topo = early.topo
    tt = jtraffic.uniform_random(topo, 0.5, 0.3, 1536, JPHY.pkt_flits,
                                 seed=5)
    floors = jsim.pack_dims(topo, tt)             # the longer table's K
    early = _replay_packed(2048, floors)
    late = jsim.pack(topo, early.rt, tt, JPHY, JSim(cycles=1536, warmup=0),
                     phy_spec=early.phy_link.spec, floors=floors)
    want = [np_tree(jsim.run(ps)) for ps in (early, late)]
    mono = np_tree(jsim.run(early, driver="monolithic"))
    assert_states_equal(mono, want[0], skip=("drain_cycle",))
    assert int(want[0]["drain_cycle"]) == 1024
    assert int(want[1]["drain_cycle"]) == 1536
    got = np_tree(tsim.run_batch([port_packed(ps) for ps in (early, late)]))
    for g in range(2):
        assert_states_equal(want[g], {k: v[g] for k, v in got.items()})
    # without the replay the drained lane keeps its cycle-1024 tables
    monkeypatch.setattr(chunked, "replay_windows", lambda fn, st, *a: st)
    skipped = np_tree(tsim.run_batch([port_packed(early)]))
    assert int(skipped["wl_resel"][0]) < int(want[0]["wl_resel"])


def test_drop_credited_trace_drains_like_jax():
    """ARQ-exhausted multicast drops credit the barrier once per member:
    every phase closes and the lane drains early, with the loss reported
    (``trace_done`` False) — equal to the JAX engine leaf for leaf."""
    topo = jbuild(4, 4, JFabric.WIRELESS)
    tr = Trace("lossy", 8, [
        phase([mcast(0, (2, 3, 4, 5, 6, 7), 256.0),
               mcast(4, (0, 1, 2, 3), 256.0)], label="a"),
        phase([p2p(1, 6, 256.0), p2p(6, 1, 256.0)], label="b")])
    tt = jtraffic.from_trace(topo, tr, JPHY.pkt_flits)
    ps = jsim.pack(topo, jrouting(topo), tt, JPHY,
                   JSim(cycles=4096, warmup=0),
                   phy_spec=JSpec(link_budget_db=12.0, max_retx=1))
    want = np_tree(jsim.run(ps))
    ps_t = port_packed(ps)
    st = tsim.run(ps_t)
    assert_states_equal(want, np_tree(st))
    from repro_torch.core.metrics import compute_metrics
    m = compute_metrics(ps_t, st, "lossy", 0.0)
    assert m.wl_dropped > 0 and m.wl_dropped_payload > 0
    assert m.phases_done == m.n_phases > 0
    assert 0 < m.drain_cycle < 4096 and not m.trace_done


def test_fixture_wireless_values_match_bench_file():
    """The JAX fixture's wireless fig9 values equal the reference's
    ``BENCH_fig9_phy.json`` (rounded to 4 decimals there)."""
    fx = json.loads((FIXTURES / "fig9_reference.json").read_text())
    bench = json.loads((FIXTURES.parents[1] / "BENCH_fig9_phy.json")
                       .read_text())
    pairs = (("wl_goodput_gbps", "goodput_gbps"), ("wl_air_eff", "air_eff"),
             ("throughput", "throughput"), ("wl_retx_rate", "retx_rate"),
             ("wl_dropped", "dropped"), ("energy_pj_bit", "pj_bit"))
    n = 0
    for p in fx["quality"]:
        c, m = p["case"], p["metrics"]
        if c["fabric"] != int(JFabric.WIRELESS):
            continue
        key = f"b{c['budget_db']:g}_{c['policy']}_"
        for f, k in pairs:
            v = m[f]
            assert (round(v, 4) if isinstance(v, float) else v) \
                == bench[key + k], key + k
            n += 1
    for p in fx["drift"]:
        c, m = p["case"], p["metrics"]
        key = f"drift{c['amp_db']:g}_{c['arm']}_"
        for f, k in (("wl_air_eff", "air_eff"),
                     ("wl_goodput_gbps", "goodput_gbps"),
                     ("wl_resel", "resel")):
            v = m[f]
            assert (round(v, 4) if isinstance(v, float) else v) \
                == bench[key + k], key + k
            n += 1
    mc = fx["mc_trace"]["metrics"]
    assert mc["phases_done"] == bench["mc_trace_phases_done"]
    assert mc["wl_dropped_payload"] == bench["mc_trace_dropped_payload"]
    assert n == 18 * 6 + 16 * 3
