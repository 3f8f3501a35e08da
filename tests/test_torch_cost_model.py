"""The port's roofline and fabric-energy arithmetic
(``interconnect/cost_model.py``) against the JAX package's: ``model_flops``
for every registered config and shape, and every property, ``row`` and
``fabric_energy_mj`` of ``Roofline``.  Pure Python float arithmetic, copied,
so the results are held equal exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.interconnect import cost_model as jcm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.interconnect import cost_model as cm  # noqa: E402

ARCHS = sorted(jbase.all_configs())
PROPS = ("t_compute", "t_memory", "t_collective", "bottleneck", "t_step",
         "useful_flop_ratio", "roofline_fraction")


def test_the_port_has_every_config():
    assert sorted(base.all_configs()) == ARCHS and len(ARCHS) == 10


def test_v5e_constants_are_the_references():
    assert dataclasses.asdict(cm.V5E) == dataclasses.asdict(jcm.V5E)
    assert cm.Roofline.HEADER == jcm.Roofline.HEADER


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for name, shape in jbase.SHAPES.items():
        got = cm.model_flops(base.get_config(arch), base.SHAPES[name])
        assert got == jcm.model_flops(jbase.get_config(arch), shape), name


def _rooflines(arch, shape_name, k):
    """Both packages' ``Roofline`` of one cell, its step terms derived from
    the cell's model FLOPs (the dry run's counts are not ported yet), the
    memory and collective times set to fractions of the compute time so
    that ``k`` = 0, 1, 2 makes compute, memory and the collective the
    bottleneck."""
    mf = cm.model_flops(base.get_config(arch), base.SHAPES[shape_name])
    n = 256 if k % 2 else 512
    flops = mf / n * 1.37
    t = flops / cm.V5E.peak_flops
    r_mem, r_coll = ((0.51, 0.29), (2.03, 0.47), (0.37, 3.11))[k]
    kw = dict(arch=arch, shape=shape_name, mesh=f"m{n}",
              flops_per_dev=flops, bytes_per_dev=t * cm.V5E.hbm_bw * r_mem,
              coll_bytes_per_dev=t * cm.V5E.ici_bw * r_coll,
              n_devices=n, model_flops=mf,
              peak_mem_per_dev=1.5e9 * (k + 1))
    return jcm.Roofline(**kw), cm.Roofline(**kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_rows_and_properties_equal_reference(arch):
    bottlenecks = set()
    for shape_name in jbase.SHAPES:
        for k in range(3):
            want, got = _rooflines(arch, shape_name, k)
            for prop in PROPS:
                assert getattr(got, prop) == getattr(want, prop), prop
            assert got.row() == want.row()
            assert got.fabric_energy_mj() == want.fabric_energy_mj()
            bottlenecks.add(got.bottleneck)
    assert bottlenecks == {"compute", "memory", "collective"}


def test_roofline_terms_and_bottleneck():
    """The reference's own case (``tests/test_interconnect.py``)."""
    rl = cm.Roofline(arch="a", shape="s", mesh="m",
                     flops_per_dev=197e12, bytes_per_dev=819e9 * 2,
                     coll_bytes_per_dev=50e9 * 0.5, n_devices=4,
                     model_flops=4 * 197e12 * 0.5, peak_mem_per_dev=1e9)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(2.0)
    assert rl.t_collective == pytest.approx(0.5)
    assert rl.bottleneck == "memory"
    assert rl.roofline_fraction == pytest.approx(0.5 / 2.0)
    assert rl.useful_flop_ratio == pytest.approx(0.5)
    e = rl.fabric_energy_mj()
    assert e["ici_wireline"] < e["wireless_inpackage"] < e["dcn_serial"]
