"""Write ``chunk_reference.json``: the JAX package's runs at several
execution chunks (``simulator.run(ps, chunk=)``) and its batched sweep
under both drivers (``run_sweep_batched(driver=)``).

- ``open``: the point of ``tests/test_chunked_exec.py``'s
  ``test_chunk_size_invariance`` (4C4M wireless, uniform traffic at load
  0.5 with 20% memory traffic, 700 cycles with 100 of warm-up, traffic
  seed 5) at chunks 32, 96, 128 and 256;
- ``living``: a fig9 drift point (19 dB link budget, 4 dB drift with
  in-scan re-selection, load 0.5) whose births are cut to the first 16
  cycles, so that it drains at cycle 480 under chunk 96 (not a multiple
  of the 128-cycle window: the boundaries from 512 on fire only in the
  driver's replay) and at 512 under chunk 128, before its 640-cycle
  budget;
- ``sweep``: substrate, interposer and wireless 4C4M at load 0.5 with a
  64-cycle traffic table (32 cycles of warm-up) run to a 512-cycle
  budget (``cycles=512``), under ``driver="monolithic"`` and
  ``driver="chunked"``; in the chunked run the wireless lane drains at
  384 and stays frozen while the wireline lanes run on; with the move of
  ``sweep.POINTS_RUN`` over the two calls.

Each run is stored with every ``SimState`` leaf (dtype, shape and the
zlib-compressed little-endian bytes; uint32 leaves as int64, the port's
dtype for them) or every ``Metrics`` field.  ``chip_smoke.py`` rebuilds
the points with the port from the cases and holds its runs on the card
against this file.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_chunk_reference.py
"""
import base64
import dataclasses
import json
import pathlib
import zlib

import numpy as np

from repro.core import simulator, sweep, traffic
from repro.core.constants import DEFAULT_PHY, Fabric, SimParams
from repro.core.routing import compute_routing
from repro.core.topology import build_xcym
from repro.phy import PhySweepSpec

OUT = pathlib.Path(__file__).parent / "chunk_reference.json"
OPEN = dict(n_chips=4, n_mem=4, fabric=int(Fabric.WIRELESS), load=0.5,
            p_mem=0.2, traffic_seed=5, cycles=700, warmup=100,
            chunks=[32, 96, 128, 256])
LIVING = dict(n_chips=4, n_mem=4, fabric=int(Fabric.WIRELESS), load=0.5,
              p_mem=0.2, traffic_seed=0, birth_cycles=16, cycles=640,
              warmup=0, budget_db=19.0, drift_amp_db=4.0, reselect=True,
              chunks=[96, 128])
SWEEP = dict(n_chips=4, n_mem=4, load=0.5, p_mem=0.2,
             sim=dict(cycles=64, warmup=32, seed=0), cycles=512,
             fabrics=[int(f) for f in (Fabric.SUBSTRATE, Fabric.INTERPOSER,
                                       Fabric.WIRELESS)])


def packed(c: dict):
    """The case's point packed by the JAX package (no floors)."""
    topo = build_xcym(c["n_chips"], c["n_mem"], Fabric(c["fabric"]))
    births = c.get("birth_cycles", c["cycles"])
    tt = traffic.uniform_random(topo, c["load"], c["p_mem"], births,
                                DEFAULT_PHY.pkt_flits, seed=c["traffic_seed"])
    spec = PhySweepSpec(link_budget_db=c["budget_db"],
                        drift_amp_db=c["drift_amp_db"],
                        reselect=c["reselect"]) if "budget_db" in c else None
    return simulator.pack(topo, compute_routing(topo), tt, DEFAULT_PHY,
                          SimParams(cycles=c["cycles"], warmup=c["warmup"]),
                          phy_spec=spec)


def leaves(st) -> dict:
    out = {}
    for k, v in st._asdict().items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        a = np.asarray(a, a.dtype.newbyteorder("<"))
        out[k] = dict(dtype=a.dtype.name, shape=list(a.shape),
                      data=base64.b64encode(zlib.compress(a.tobytes(), 9))
                      .decode())
    return out


def runs(c: dict) -> dict:
    ps = packed(c)
    out = {}
    for chunk in c["chunks"]:
        st = simulator.run(ps, chunk=chunk)
        out[str(chunk)] = dict(drain_cycle=int(st.drain_cycle),
                               state=leaves(st))
    return out


def sweep_runs(c: dict) -> dict:
    pts = [sweep.SweepPoint(c["n_chips"], c["n_mem"], Fabric(f),
                            load=c["load"], p_mem=c["p_mem"],
                            sim=SimParams(**c["sim"]))
           for f in c["fabrics"]]
    before = sweep.POINTS_RUN
    out = {d: [dataclasses.asdict(m) for m in sweep.run_sweep_batched(
        pts, cycles=c["cycles"], driver=d)]
        for d in ("monolithic", "chunked")}
    out["points_run"] = sweep.POINTS_RUN - before
    return out


def main() -> None:
    rec = {"open": dict(case=OPEN, chunks=runs(OPEN)),
           "living": dict(case=LIVING, chunks=runs(LIVING)),
           "sweep": dict(case=SWEEP, **sweep_runs(SWEEP))}
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    for k in ("open", "living"):
        print(k, {c: r["drain_cycle"] for c, r in rec[k]["chunks"].items()})
    print("sweep drain", [m["drain_cycle"] for m in rec["sweep"]["chunked"]],
          [m["drain_cycle"] for m in rec["sweep"]["monolithic"]])
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
