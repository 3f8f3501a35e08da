"""The port's host-side tables and ``pack`` against the JAX package's.

Topology, routing, traffic tables and the packed ``SimStatic`` plus the
initial ``SimState`` must be byte-identical (name, dtype, shape, bytes) —
the port keeps its own copies of the numpy modules.  A subprocess checks
that importing the port pulls in neither JAX nor the reference package.
"""
import dataclasses
import enum
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

from repro.core import simulator as jsim  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.constants import Fabric as JFabric  # noqa: E402
from repro.core.constants import SimParams as JSimParams  # noqa: E402
from repro.core.routing import compute_routing as jrouting  # noqa: E402
from repro.core.topology import build_xcym as jbuild  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.constants import Fabric as TFabric  # noqa: E402
from repro_torch.core.constants import SimParams as TSimParams  # noqa: E402
from repro_torch.core.routing import compute_routing as trouting  # noqa: E402
from repro_torch.core.topology import build_xcym as tbuild  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the four open-loop golden points (tests/test_golden_metrics.py), plus a
# smaller and a larger system
CASES = {
    "wireless_4c4m_load02": dict(n_chips=4, fabric=2, load=0.2, cycles=1500),
    "interposer_4c4m_load02": dict(n_chips=4, fabric=1, load=0.2,
                                   cycles=1500),
    "substrate_4c4m_load02": dict(n_chips=4, fabric=0, load=0.2, cycles=1500),
    "app_canneal_wireless_4c4m": dict(n_chips=4, fabric=2, load=1.0,
                                      cycles=1500, app="canneal"),
    "wireless_1c4m_load05": dict(n_chips=1, fabric=2, load=0.5, cycles=500),
    "wireless_8c4m_load05": dict(n_chips=8, fabric=2, load=0.5, cycles=500),
}


def assert_same(a, b, what):
    """Byte-for-byte equality of arrays; structural equality otherwise."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    elif dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), what
    elif isinstance(a, enum.Enum):
        assert int(a) == int(b), what
    else:
        assert a == b, (what, a, b)


def _build_both(case):
    sim_kw = dict(cycles=case["cycles"], warmup=300, seed=0)
    topo_j = jbuild(case["n_chips"], 4, JFabric(case["fabric"]))
    topo_t = tbuild(case["n_chips"], 4, TFabric(case["fabric"]))
    rt_j, rt_t = jrouting(topo_j), trouting(topo_t)
    if case.get("app"):
        tt_j = jtraffic.application(topo_j, jtraffic.APP_MODELS[case["app"]],
                                    case["cycles"], 64, seed=0,
                                    load_scale=case["load"])
        tt_t = ttraffic.application(topo_t, ttraffic.APP_MODELS[case["app"]],
                                    case["cycles"], 64, seed=0,
                                    load_scale=case["load"])
    else:
        tt_j = jtraffic.uniform_random(topo_j, case["load"], 0.2,
                                       case["cycles"], 64, seed=0)
        tt_t = ttraffic.uniform_random(topo_t, case["load"], 0.2,
                                       case["cycles"], 64, seed=0)
    return ((topo_j, rt_j, tt_j, JSimParams(**sim_kw)),
            (topo_t, rt_t, tt_t, TSimParams(**sim_kw)))


@pytest.mark.parametrize("name", list(CASES))
def test_host_tables_byte_identical(name):
    (topo_j, rt_j, tt_j, _), (topo_t, rt_t, tt_t, _) = _build_both(CASES[name])
    for f in dataclasses.fields(topo_j):
        assert_same(getattr(topo_j, f.name), getattr(topo_t, f.name),
                    f"topology.{f.name}")
    for f in dataclasses.fields(rt_j):
        assert_same(getattr(rt_j, f.name), getattr(rt_t, f.name),
                    f"routing.{f.name}")
    for f in dataclasses.fields(tt_j):
        assert_same(getattr(tt_j, f.name), getattr(tt_t, f.name),
                    f"traffic.{f.name}")


@pytest.mark.parametrize("name", list(CASES))
def test_pack_and_init_state_byte_identical(name):
    (topo_j, rt_j, tt_j, sim_j), (topo_t, rt_t, tt_t, sim_t) = \
        _build_both(CASES[name])
    ps_j = jsim.pack(topo_j, rt_j, tt_j, topo_j.phy, sim_j)
    ps_t = tsim.pack(topo_t, rt_t, tt_t, topo_t.phy, sim_t, device="cpu")
    assert ps_t.dims == ps_j.dims
    assert not (ps_j.mem_on or ps_j.phy_on or ps_j.drift_on or ps_j.reselect)
    # the key also names the step program: the reference's flags (mem_on,
    # phy_on, drift_on, reselect) and the port's mc_on, all off for these
    # open-loop tables
    key_j = ps_j.shape_key()
    assert ps_t.shape_key() == key_j[:4] + (("mc_on", False),) + key_j[4:]
    ss_t = carry.state_to_numpy(ps_t.ss)
    assert list(ss_t) == list(jsim.SimStatic._fields)
    for k, v in ps_j.ss._asdict().items():
        v = np.asarray(v)
        if k == "phy_seed":          # the u32 seed, held in int64 by pack
            v = v.astype(np.int64)
        assert_same(v, ss_t[k], f"SimStatic.{k}")
    st_j = jsim.init_state(*jsim._state_dims(ps_j))
    st_t = carry.state_to_numpy(
        tsim.init_state(*tsim._state_dims(ps_t), device="cpu"))
    assert list(st_t) == list(jsim.SimState._fields)
    for k, v in st_j._asdict().items():
        assert_same(np.asarray(v), st_t[k], f"SimState.{k}")


def test_carry_round_trip_and_field_check():
    (topo_j, rt_j, tt_j, sim_j), _ = _build_both(CASES["wireless_1c4m_load05"])
    ps_j = jsim.pack(topo_j, rt_j, tt_j, topo_j.phy, sim_j)
    fields = {k: np.asarray(v) for k, v in ps_j.ss._asdict().items()}
    back = carry.state_to_numpy(carry.static_from_numpy(fields, "cpu"))
    for k, v in fields.items():
        assert_same(v, back[k], k)
    with pytest.raises(ValueError, match="missing"):
        carry.static_from_numpy({k: v for k, v in fields.items()
                                 if k != "births"}, "cpu")


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.kernels.ops, "
            "repro_torch.core.sweep, repro_torch.carry\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_port_module_nor_the_smoke_imports_jax_or_ml_dtypes():
    """Every module of the port, and ``chip_smoke.py``, imported in a
    fresh interpreter: none of them brings in ``jax``, ``ml_dtypes`` (the
    card's machine has neither) or anything of the reference."""
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.path.insert(0, '.')\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], check=True, env=env,
                         cwd=ROOT, timeout=300, capture_output=True,
                         text=True)
    assert int(out.stdout.split()[-1]) > 40
