"""fig7's ML traces and fig8's closed-loop memory grid, built by the port.

The points of ``benchmarks/fig7_ml_traces.py`` and
``benchmarks/fig8_memory.py`` at paper size, rebuilt from the cases of
the fixtures the JAX package writes (``tests/torch_fixtures/
make_fig7_reference.py``, ``make_fig8_reference.py``), so that the port
runs exactly the grid its reference numbers come from.  The compiled psum
trace is parsed from the fixture's HLO text (the card's machine has no
JAX).  Used by ``chip_smoke.py`` and ``step_profile.py``; needs ``src/``
on ``sys.path``.
"""
from __future__ import annotations

import json
import pathlib

FIXTURES = pathlib.Path(__file__).resolve().parents[1] / "tests" \
    / "torch_fixtures"
N_CHIPS, N_MEM, N_DEV = 4, 4, 16
TARGET_PKTS = 120
# (name, model, schedule); model None = the compiled psum trace
FIG7_RECIPES = (("gemma-7b", "gemma-7b", "auto"),
                ("mixtral-8x22b", "mixtral-8x22b", "auto"),
                ("llama3-405b", "llama3-405b", "auto"),
                ("gemma-7b-oneshot", "gemma-7b", "oneshot"),
                ("compiled", None, "auto"))
FIG7_FABRICS = ("WIRELESS", "INTERPOSER", "SUBSTRATE")


def fixture(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


def autoscale(tr, pkt_bytes: float = 256.0):
    """fig7's ``_autoscale``: ~TARGET_PKTS packets per emitted table."""
    total = tr.bytes_total()
    n_msgs = sum(len(p.messages) for p in tr.phases)
    want = max(TARGET_PKTS, n_msgs) * pkt_bytes
    return tr.scaled(want / max(total, 1.0))


def fig7_traces(names) -> list:
    """``[(name, Trace)]`` for fig7's traces called ``names``, in
    ``FIG7_RECIPES`` order, each scaled to ~TARGET_PKTS packets."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.constants import Fabric
    from repro_torch.core.topology import build_xcym
    from repro_torch.workloads.hlo import trace_from_hlo
    from repro_torch.workloads.mapping import DeviceMap
    from repro_torch.workloads.synthetic import synthetic_dnn_trace

    dm = DeviceMap(build_xcym(N_CHIPS, N_MEM, Fabric.WIRELESS), N_DEV)
    out = []
    for name, model, sched in FIG7_RECIPES:
        if name not in names:
            continue
        if model is None:
            tr = trace_from_hlo((FIXTURES / "fig7_psum.hlo.txt").read_text(),
                                dm, name="compiled:psum-step")
        else:
            tr = synthetic_dnn_trace(get_config(model), dm, tokens=2048,
                                     n_layers_cap=1, schedule=sched)
        out.append((name, autoscale(tr)))
    return out


def fig7_point(name: str, tr, fabric: str, sim):
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    return SweepPoint(N_CHIPS, N_MEM, Fabric[fabric], trace=tr, sim=sim,
                      name=f"{name}/{fabric.lower()}")


def fig8_point(case: dict, sim):
    """One fig8 point from its fixture case: closed-loop memory traffic at
    ``load`` with a ``max_outstanding`` window, or an app closed-loop."""
    from repro_torch.core.constants import Fabric
    from repro_torch.core.sweep import SweepPoint
    from repro_torch.memory import DramTimingParams, MemSweepSpec
    if "app" in case:
        return SweepPoint(N_CHIPS, N_MEM, Fabric(case["fabric"]),
                          load=case["load"], app=case["app"],
                          closed_loop=True, sim=sim)
    dram = DramTimingParams(max_outstanding=case["max_outstanding"])
    return SweepPoint(N_CHIPS, N_MEM, Fabric(case["fabric"]), sim=sim,
                      mem=MemSweepSpec(load=case["load"], dram=dram))
