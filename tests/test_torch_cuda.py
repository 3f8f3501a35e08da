"""Tests of the port that need a CUDA card (marked ``cuda``; they skip
without one).  Torch only, so they also run where JAX is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

- the RMSNorm kernel against its plain version at the kernel test's
  shapes and tolerances (f32 1e-5, bf16 2e-2), one launch per call;
- the wrapper refuses what the kernel does not take (no fallback);
- the simulator on the card equals the simulator on the CPU, every
  ``SimState`` leaf exactly, for a single point and a mixed-budget batch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator, sweep  # noqa: E402
from repro_torch.core.constants import Fabric, MacMode, SimParams  # noqa: E402
from repro_torch.kernels import ops, rmsnorm  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402

pytestmark = pytest.mark.cuda

CASES = [
    ((128, 512), torch.float32, 1e-5),
    ((2, 64, 1024), torch.float32, 1e-5),
    ((300, 768), torch.float32, 1e-5),          # ragged rows
    ((128, 2048), torch.bfloat16, 2e-2),
    ((4, 32, 256), torch.bfloat16, 2e-2),
    ((8192, 4096), torch.bfloat16, 2e-2),
    ((7, 1001), torch.float32, 1e-5),           # d not a multiple of 4
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, dtype, device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy(
        (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.parametrize("case", CASES)
def test_rmsnorm_kernel_matches_plain_version(case, cuda):
    shape, dtype, tol = case
    x, w = _inputs(shape, dtype, cuda)
    before = rmsnorm.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == shape
    want = rmsnorm_ref(x, w)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


def test_rmsnorm_wrapper_refuses_unsupported_inputs(cuda):
    x, w = _inputs((16, 64), torch.float32, cuda)
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm_2d(x.half(), w.half())
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_2d(x.t(), w[:16])          # not contiguous
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_2d(x, w.cpu())             # mixed devices


def _packed(device, fabric, load, cycles, **sim_kw):
    topo, rt = sweep._cached_system(4, 4, fabric, sweep.DEFAULT_PHY, 3.0)
    tt = sweep.traffic.uniform_random(topo, load, 0.2, cycles, 64, seed=0)
    sim = SimParams(cycles=cycles, warmup=100, **sim_kw)
    floors = {"B": 320, "S": 72, "R": 384, "K": 32, "CS": 8, "CR": 32}
    return simulator.pack(topo, rt, tt, topo.phy, sim, floors=floors,
                          device=device)


def _assert_same(a: dict, b: dict):
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_simulator_on_card_equals_cpu(cuda):
    args = (Fabric.WIRELESS, 0.5, 300)
    got = carry.state_to_numpy(simulator.run(_packed(cuda, *args)))
    want = carry.state_to_numpy(simulator.run(_packed("cpu", *args)))
    _assert_same(want, got)


def test_mixed_batch_on_card_equals_cpu(cuda):
    pts = [(Fabric.WIRELESS, 0.5, 300, {}),
           (Fabric.INTERPOSER, 0.5, 200, {}),
           (Fabric.SUBSTRATE, 0.3, 430, {}),
           (Fabric.WIRELESS, 0.4, 260, dict(mac=MacMode.TOKEN))]
    outs = [carry.state_to_numpy(simulator.run_batch(
        [_packed(dev, f, l, c, **kw) for f, l, c, kw in pts]))
        for dev in (cuda, "cpu")]
    _assert_same(outs[1], outs[0])
