"""Write ``fig7_psum.hlo.txt`` and ``fig7_reference.json``: the JAX
package's fig7 ML traces at paper size.

The traces of ``benchmarks/fig7_ml_traces.py``: gemma-7b, mixtral-8x22b
and llama3-405b from ``synthetic_dnn_trace(tokens=2048, n_layers_cap=1)``,
the gemma-7b one-shot variant, and the compiled psum step (its HLO text
from a 4-device CPU split, written to ``fig7_psum.hlo.txt`` so that a
machine without JAX can parse the same text), each scaled to ~120
packets, on the three fabrics: 15 points, 16 devices on 4C4M, a budget of
96 000 cycles with early drain, in one ``run_sweep_batched`` call.  Each
point is stored with every ``Metrics`` field and the analytic link
energy per bit of its emitted table (``fabric.price_table``);
``chip_smoke.py`` holds the port's run against them.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fig7_reference.py
"""
import dataclasses
import json
import os
import pathlib

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.core import traffic  # noqa: E402
from repro.core.constants import Fabric, SimParams  # noqa: E402
from repro.core.sweep import SweepPoint, run_sweep_batched  # noqa: E402
from repro.core.topology import build_xcym  # noqa: E402
from repro.interconnect.fabric import price_table  # noqa: E402
from repro.workloads.hlo import trace_from_hlo  # noqa: E402
from repro.workloads.mapping import DeviceMap  # noqa: E402
from repro.workloads.synthetic import synthetic_dnn_trace  # noqa: E402

HERE = pathlib.Path(__file__).parent
OUT = HERE / "fig7_reference.json"
HLO = HERE / "fig7_psum.hlo.txt"
N_CHIPS, N_MEM, N_DEV = 4, 4, 16
TARGET_PKTS = 120
SIM = SimParams(cycles=96_000, warmup=0, seed=0)
FABRICS = (Fabric.WIRELESS, Fabric.INTERPOSER, Fabric.SUBSTRATE)
# (name, model, schedule); model None = the compiled psum trace
RECIPES = (("gemma-7b", "gemma-7b", "auto"),
           ("mixtral-8x22b", "mixtral-8x22b", "auto"),
           ("llama3-405b", "llama3-405b", "auto"),
           ("gemma-7b-oneshot", "gemma-7b", "oneshot"),
           ("compiled", None, "auto"))


def autoscale(tr, pkt_bytes: float = 256.0):
    """fig7's ``_autoscale``: ~TARGET_PKTS packets per emitted table."""
    total = tr.bytes_total()
    n_msgs = sum(len(p.messages) for p in tr.phases)
    want = max(TARGET_PKTS, n_msgs) * pkt_bytes
    return tr.scaled(want / max(total, 1.0))


def psum_hlo() -> str:
    """fig7's ``_compiled_trace`` step, lowered and compiled to HLO text."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    assert jax.device_count() == 4, jax.device_count()
    mesh = Mesh(np.array(jax.devices()), ("d",))

    def stepfn(x, w):
        y = jnp.tanh(x @ w)
        return jax.lax.pmean(y, "d"), jax.lax.psum(y @ w.T, "d")

    n = 64
    sh = NamedSharding(mesh, P("d", None))
    x = jax.ShapeDtypeStruct((len(jax.devices()) * 4, n), jnp.float32,
                             sharding=sh)
    w = jax.ShapeDtypeStruct((n, n), jnp.float32)
    fn = shard_map(stepfn, mesh=mesh, in_specs=(P("d", None), P(None, None)),
                   out_specs=(P("d", None), P(None, None)))
    return jax.jit(fn).lower(x, w).compile().as_text()


def traces(dm: DeviceMap, hlo: str) -> list:
    out = []
    for name, model, sched in RECIPES:
        if model is None:
            tr = trace_from_hlo(hlo, dm, name="compiled:psum-step")
        else:
            tr = synthetic_dnn_trace(get_config(model), dm, tokens=2048,
                                     n_layers_cap=1, schedule=sched)
        out.append((name, autoscale(tr)))
    return out


def main() -> None:
    hlo = psum_hlo()
    HLO.write_text(hlo)
    dm = DeviceMap(build_xcym(N_CHIPS, N_MEM, Fabric.WIRELESS), N_DEV)
    trs = traces(dm, hlo)
    pts, meta = [], []
    for name, tr in trs:
        for fab in FABRICS:
            pts.append(SweepPoint(N_CHIPS, N_MEM, fab, trace=tr, sim=SIM,
                                  name=f"{name}/{fab.name.lower()}"))
            meta.append((name, tr, fab))
    ms = run_sweep_batched(pts)
    rec = {"sim": {"cycles": SIM.cycles, "warmup": SIM.warmup,
                   "seed": SIM.seed},
           "traces": [{"name": n, "describe": tr.describe(),
                       "n_phases": tr.n_phases,
                       "bytes_total": tr.bytes_total()} for n, tr in trs],
           "points": []}
    for (name, tr, fab), m in zip(meta, ms):
        topo = build_xcym(N_CHIPS, N_MEM, fab)
        tt = traffic.from_trace(topo, tr, pts[0].phy.pkt_flits)
        _tot, pj_bit = price_table(topo, tt, pts[0].phy.pkt_flits,
                                   pts[0].phy.flit_bits)
        rec["points"].append({"trace": name, "fabric": int(fab),
                              "analytic_pj_bit": pj_bit,
                              "phase_labels": list(tt.phase_labels),
                              "metrics": dataclasses.asdict(m)})
    OUT.write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
    print(f"wrote {HLO} and {OUT}: {len(pts)} points, slowest drain "
          f"{max(m.drain_cycle for m in ms)}")


if __name__ == "__main__":
    main()
