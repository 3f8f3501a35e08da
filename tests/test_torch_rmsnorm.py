"""RMSNorm: the port's plain version and ``ops.rmsnorm`` against the JAX
package's ``ops.rmsnorm`` (Pallas kernel in interpret mode).  The CUDA
kernel against its plain version is in ``test_torch_cuda.py``.

Inputs come from numpy with a fixed seed and go to both frameworks (bf16
inputs are rounded from the same f32 values in each).  Tolerances are those
of ``tests/test_kernels_rmsnorm.py``: 1e-5 for f32, 2e-2 for bf16 (outputs
rounded to bf16 in both).  Gradients are held to rel 1e-5 of the largest
reference entry (f32; sums over rows run in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, rmsnorm  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402

CASES = [
    ((128, 512), "float32", 1e-5),
    ((2, 64, 1024), "float32", 1e-5),
    ((300, 768), "float32", 1e-5),          # ragged rows
    ((128, 2048), "bfloat16", 2e-2),
    ((4, 32, 256), "bfloat16", 2e-2),
]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("case", CASES)
def test_rmsnorm_matches_jax(case):
    shape, dtype, tol = case
    x, w = _inputs(shape)
    want = np.asarray(jops.rmsnorm(jnp.asarray(x, JDT[dtype]),
                                   jnp.asarray(w, JDT[dtype]),
                                   interpret=True), np.float32)
    xt = torch.from_numpy(x).to(TDT[dtype])
    wt = torch.from_numpy(w).to(TDT[dtype])
    for got in (ops.rmsnorm(xt, wt), rmsnorm_ref(xt, wt)):
        assert got.dtype == TDT[dtype] and tuple(got.shape) == shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_rmsnorm_gradients_match_jax():
    x, w = _inputs((64, 128), seed=1)
    cot = np.random.default_rng(2).standard_normal((64, 128)).astype(
        np.float32)
    gx_j, gw_j = jax.grad(
        lambda x, w: (jops.rmsnorm(x, w, interpret=True) * cot).sum(),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (ops.rmsnorm(xt, wt) * torch.from_numpy(cot)).sum().backward()
    for got, want in ((xt.grad, gx_j), (wt.grad, gw_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_cpu_takes_plain_version_and_other_devices_raise():
    x = torch.ones(4, 8)
    w = torch.ones(8)
    before = rmsnorm.launches
    assert torch.equal(rmsnorm.rmsnorm_2d(x, w), rmsnorm_ref(x, w))
    assert rmsnorm.launches == before            # no kernel launched
    with pytest.raises(ValueError):
        rmsnorm.rmsnorm_2d(x.to("meta"), w.to("meta"))

