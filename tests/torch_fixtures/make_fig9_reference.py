"""Write ``fig9_reference.json``: the JAX package's fig9 at paper size.

The three parts of ``benchmarks/fig9_lossy_channel.py`` without
``FIG9_SMOKE``:

- the quality grid: link budgets 13/15/17/19/22/26 dB x rate policies
  adaptive/fixed:0/fixed:-1 x the three fabrics, 4C4M at load 0.5 with
  20% memory traffic, 6 000 cycles with 1 000 of warm-up (54 points);
- the drift sweep at 19 dB: aging amplitudes 0/2/4/6 dB x the arms
  online (in-scan re-selection), static (the host pick left alone),
  fixed:0 and fixed:-1 (16 points);
- the one-shot all-reduce multicast trace (16 devices) over the lossy
  channel at 22 dB with ``max_retx`` 3, 8 000 cycles (broadcast ARQ).

Three more records hold details the figure does not reach: ``bcast``, a
small multicast trace (8 devices, an all-reduce and a permute phase) at
12 dB with ``max_retx`` 1, whose ARQ drops close the phase barriers on
drop credits so that it drains early; ``replay``, a
short-birth living point (births within 256 cycles, a 2 048-cycle
budget, drift 4 dB and re-selection) that drains long before its budget,
so its last window boundaries fire only in the drain-aware driver's
replay; and ``windows``, the drifted per-entry PER thresholds and the
re-selected rate of every scan window the drift points visit, per
amplitude, from the compiled window update, as zlib-compressed
little-endian int32.  Each point
is stored with its case and every ``Metrics`` field; ``chip_smoke.py``
rebuilds the points from the cases and holds the port's run against them
(integers exact, floats rel 1e-6).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fig9_reference.py
"""
import base64
import dataclasses
import json
import os
import pathlib
import zlib

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import simulator, traffic  # noqa: E402
from repro.core.chunked import CHUNK_CYCLES  # noqa: E402
from repro.core.constants import DEFAULT_PHY, Fabric, SimParams  # noqa: E402
from repro.core.metrics import compute_metrics  # noqa: E402
from repro.core.routing import compute_routing  # noqa: E402
from repro.core.sweep import SweepPoint, run_sweep_batched  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro.phy import PhySweepSpec  # noqa: E402
from repro.workloads.mapping import DeviceMap  # noqa: E402
from repro.workloads.schedules import expand_collective  # noqa: E402
from repro.workloads.trace import Trace, mcast, p2p, phase  # noqa: E402

OUT = pathlib.Path(__file__).parent / "fig9_reference.json"
SIM = SimParams(cycles=6_000, warmup=1_000, seed=0)
BUDGETS_DB = (13.0, 15.0, 17.0, 19.0, 22.0, 26.0)
POLICIES = ("adaptive", "fixed:0", "fixed:-1")
FABRICS = (Fabric.SUBSTRATE, Fabric.INTERPOSER, Fabric.WIRELESS)
LOAD, P_MEM = 0.5, 0.2
DRIFT_BUDGET_DB = 19.0
DRIFT_AMPS_DB = (0.0, 2.0, 4.0, 6.0)
DRIFT_ARMS = ("online", "static", "fixed:0", "fixed:-1")
MC = dict(budget_db=22.0, max_retx=3, cycles=8_000, payload_bytes=512.0)
BCAST = dict(budget_db=12.0, max_retx=1, cycles=1_024, payload_bytes=256.0)
REPLAY = dict(budget_db=22.0, drift_amp_db=4.0, reselect=True, seed=2,
              load=0.1, p_mem=0.3, birth_cycles=256, traffic_seed=11,
              cycles=2_048, warmup=0)


def quality_cases() -> list[dict]:
    """fig9's quality grid, in its order: budgets x policies x fabrics."""
    return [dict(budget_db=b, policy=p, fabric=int(f))
            for b in BUDGETS_DB for p in POLICIES for f in FABRICS]


def drift_cases() -> list[dict]:
    """fig9's drift sweep, in its order: amplitudes x arms."""
    return [dict(amp_db=a, arm=r) for a in DRIFT_AMPS_DB for r in DRIFT_ARMS]


def drift_spec(case: dict) -> PhySweepSpec:
    arm = case["arm"]
    policy = "adaptive" if arm in ("online", "static") else arm
    return PhySweepSpec(link_budget_db=DRIFT_BUDGET_DB, policy=policy,
                        drift_amp_db=case["amp_db"],
                        reselect=(arm == "online"))


def quality_point(case: dict) -> SweepPoint:
    return SweepPoint(4, 4, Fabric(case["fabric"]), load=LOAD, p_mem=P_MEM,
                      sim=SIM, phy_spec=PhySweepSpec(
                          link_budget_db=case["budget_db"],
                          policy=case["policy"]))


def drift_point(case: dict) -> SweepPoint:
    return SweepPoint(4, 4, Fabric.WIRELESS, load=LOAD, p_mem=P_MEM,
                      sim=SIM, phy_spec=drift_spec(case))


def mc_packed():
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    dm = DeviceMap(topo, 16)
    phases = expand_collective("all-reduce", MC["payload_bytes"], 16, dm,
                               schedule="oneshot", label="ar")
    tt = traffic.from_trace(topo, Trace("oneshot-ar", 16, phases),
                            DEFAULT_PHY.pkt_flits)
    spec = PhySweepSpec(link_budget_db=MC["budget_db"],
                        max_retx=MC["max_retx"])
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          SimParams(cycles=MC["cycles"], warmup=0),
                          phy_spec=spec)


def bcast_trace(payload: float) -> Trace:
    return Trace("bcast-lossy", 8, [
        phase([mcast(0, (2, 3, 4, 5, 6, 7), payload),
               mcast(4, (0, 1, 2, 3), payload)], label="c0:all-reduce"),
        phase([p2p(1, 6, payload), p2p(6, 1, payload)], label="c1:permute")])


def bcast_packed():
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    tt = traffic.from_trace(topo, bcast_trace(BCAST["payload_bytes"]),
                            DEFAULT_PHY.pkt_flits)
    spec = PhySweepSpec(link_budget_db=BCAST["budget_db"],
                        max_retx=BCAST["max_retx"])
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          SimParams(cycles=BCAST["cycles"], warmup=0),
                          phy_spec=spec)


def replay_packed():
    c = REPLAY
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    tt = traffic.uniform_random(topo, c["load"], c["p_mem"],
                                c["birth_cycles"], DEFAULT_PHY.pkt_flits,
                                seed=c["traffic_seed"])
    spec = PhySweepSpec(link_budget_db=c["budget_db"],
                        drift_amp_db=c["drift_amp_db"],
                        reselect=c["reselect"], seed=c["seed"])
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          SimParams(cycles=c["cycles"], warmup=c["warmup"]),
                          phy_spec=spec)


def pack_i32(a) -> str:
    return base64.b64encode(zlib.compress(
        np.ascontiguousarray(a, "<i4").tobytes(), 9)).decode()


def drift_windows() -> dict:
    """Per nonzero amplitude: the drifted PER thresholds ``perq_r`` [R, W,
    W] and the re-selected rate [W, W] of every window of the 6 000-cycle
    budget, stacked over windows (W = the fabric's wireless interfaces),
    as the compiled step computes them: through the jitted window update
    (``living.make_window_fn``), with re-selection for the rate and with
    every link held at entry ``r`` for ``perq_r[r]``."""
    from repro.phy.living import make_window_fn
    topo = build_xcym(4, 4, Fabric.WIRELESS)
    rt = compute_routing(topo)
    tt = traffic.uniform_random(topo, LOAD, P_MEM, 128, 4, seed=0)
    n = topo.n_wi
    out = {}
    for amp in DRIFT_AMPS_DB[1:]:
        ps = simulator.pack(topo, rt, tt, DEFAULT_PHY, SIM,
                            phy_spec=drift_spec(dict(amp_db=amp,
                                                     arm="online")))
        R = int(ps.ss.wl_serv_r.shape[0])
        st0 = simulator.init_state(*simulator._state_dims(ps), phy_on=True,
                                   living=True, R=R)

        def update(ss, st, t, reselect):
            return make_window_fn(ss, True, reselect)(st, t)

        upd = jax.jit(update, static_argnums=3)
        perq, rate = [], []
        for win in range(-(-SIM.cycles // CHUNK_CYCLES)):
            t = jnp.int32(win * CHUNK_CYCLES)
            rate.append(np.asarray(upd(ps.ss, st0, t, True).wl_rate_d)[:n, :n])
            per_e = []
            for e in range(R):
                fixed = jnp.full(ps.ss.wl_rate0.shape, e, jnp.int32)
                st = upd(ps.ss._replace(wl_rate0=fixed),
                         st0._replace(wl_rate_d=fixed), t, False)
                per_e.append(np.asarray(st.wl_perq_d)[:n, :n])
            perq.append(np.stack(per_e))
        out[f"{amp:g}"] = dict(n_wi=n, windows=len(perq),
                               perq_r=pack_i32(np.stack(perq)),
                               rate=pack_i32(np.stack(rate)))
    return out


def main() -> None:
    qc, dc = quality_cases(), drift_cases()
    qm = run_sweep_batched([quality_point(c) for c in qc])
    print(f"quality grid: {len(qc)} points", flush=True)
    dm = run_sweep_batched([drift_point(c) for c in dc])
    print(f"drift sweep: {len(dc)} points", flush=True)
    ps = mc_packed()
    mm = compute_metrics(ps, simulator.run(ps), "fig7-oneshot-ar/phy", 0.0)
    print("broadcast-ARQ trace", flush=True)
    bp = bcast_packed()
    bm = compute_metrics(bp, simulator.run(bp), "bcast-lossy/phy", 0.0)
    assert bm.wl_dropped > 0 and bm.drain_cycle < BCAST["cycles"]
    rp = replay_packed()
    rm = compute_metrics(rp, simulator.run(rp), "replay", 0.0)
    rmono = compute_metrics(rp, simulator.run(rp, driver="monolithic"),
                            "replay", 0.0)
    assert dataclasses.replace(rmono, drain_cycle=rm.drain_cycle) == rm
    assert rm.drain_cycle < REPLAY["cycles"] - CHUNK_CYCLES, rm.drain_cycle
    rec = {"sim": {"cycles": SIM.cycles, "warmup": SIM.warmup,
                   "seed": SIM.seed},
           "load": LOAD, "p_mem": P_MEM,
           "drift_budget_db": DRIFT_BUDGET_DB,
           "quality": [{"case": c, "metrics": dataclasses.asdict(m)}
                       for c, m in zip(qc, qm)],
           "drift": [{"case": c, "metrics": dataclasses.asdict(m)}
                     for c, m in zip(dc, dm)],
           "mc_trace": {"case": MC, "metrics": dataclasses.asdict(mm)},
           "bcast": {"case": BCAST,
                     "describe": bcast_trace(BCAST["payload_bytes"])
                     .describe(),
                     "metrics": dataclasses.asdict(bm)},
           "replay": {"case": REPLAY, "metrics": dataclasses.asdict(rm)},
           "windows": drift_windows()}
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    print(f"wrote {OUT}: {len(qc)} + {len(dc)} points, the trace, the "
          f"replay point (drains at {rm.drain_cycle})")


if __name__ == "__main__":
    main()
