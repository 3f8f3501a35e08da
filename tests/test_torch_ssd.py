"""SSD: the port's ``ref.ssd_intra_chunk_ref`` (the plain version the
kernel's wrapper takes on the CPU) against the JAX package's Pallas kernel
in interpret mode, on the cases of ``tests/test_kernels_ssd.py`` and at
hymba-1.5b's cell shape (Q 128, P 50, N 16), at 1e-5 for f32 and bf16
inputs alike (that file's own bounds are 1e-4 and 5e-2): its prefix sums
add in the reference's order (``ref.xla_cumsum``), the rest differs in f32
summation order and ``exp`` (measured 2.0e-6; 3.8e-5 with
``torch.cumsum``).  ``ops.ssd`` whole against the JAX package's
``ops.ssd`` and, for y and the final state, the model's chunked SSD:
the output and state of ``ops.ssd`` at 2e-6 (measured 1.8e-7; 7.6e-6 with
``torch.cumsum``), y against the model's formulation, which sums in
another order, at 2e-4 (measured 2.1e-6).  The CUDA kernel against its
plain version is in ``test_torch_cuda.py``.

Inputs come from numpy with a fixed seed and go to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# intra-op threads of parallel test workers only contend for the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra_chunk as jssd  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ssd_scan  # noqa: E402
from repro_torch.kernels.ref import ssd_intra_chunk_ref  # noqa: E402

CASES = [
    # (BH, c, Q, P, N, dtype, tol)
    (2, 2, 16, 8, 16, "float32", 1e-5),
    (4, 4, 32, 16, 32, "float32", 1e-5),
    (1, 1, 64, 64, 128, "float32", 1e-5),
    (2, 2, 16, 8, 16, "bfloat16", 1e-5),
    (2, 2, 128, 50, 16, "float32", 1e-5),        # hymba-1.5b's cell shape
    (2, 2, 128, 50, 16, "bfloat16", 1e-5),
]


def _inputs(BH, c, Q, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, c, Q, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, c, Q)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(BH)).astype(np.float32)
    B = rng.standard_normal((BH, c, Q, N)).astype(np.float32)
    C = rng.standard_normal((BH, c, Q, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", CASES)
def test_intra_chunk_matches_jax_kernel(case):
    BH, c, Q, P, N, dtype, tol = case
    x, dt, A, B, C = _inputs(BH, c, Q, P, N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jssd(jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(A),
                jnp.asarray(B, jdt), jnp.asarray(C, jdt), interpret=True)
    tx, tB, tC = (torch.from_numpy(a).to(tdt) for a in (x, B, C))
    tdt_, tA = torch.from_numpy(dt), torch.from_numpy(A)
    for fn in (ssd_intra_chunk_ref, ssd_scan.ssd_intra_chunk):
        got = fn(tx, tdt_, tA, tB, tC)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                       atol=tol)


def _full_inputs(b, l, h, p, n, seed=3):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, l, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("shape,chunk", [((2, 32, 8, 16, 16), 8),
                                         ((1, 64, 4, 16, 32), 16),
                                         ((1, 24, 2, 8, 8), 64)])
def test_full_ssd_matches_jax(shape, chunk):
    arrs = _full_inputs(*shape)
    ja = [jnp.asarray(a) for a in arrs]
    y_j, st_j = jops.ssd(*ja, chunk=chunk, interpret=True)
    before = ssd_scan.launches
    y_t, st_t = ops.ssd(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    assert ssd_scan.launches == before           # the CPU runs no kernel
    assert y_t.dtype == torch.float32 and st_t.dtype == torch.float32
    for got, want in ((y_t, y_j), (st_t, st_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)
    if chunk <= shape[1]:                        # the model's oracle
        y_m, st_m = jssm.ssd_chunked(*ja, chunk=chunk)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_m), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_m),
                                   rtol=2e-6, atol=2e-6)


def test_full_ssd_bf16_input_keeps_dtype():
    arrs = _full_inputs(1, 32, 2, 8, 8)
    ja = [jnp.asarray(a) for a in arrs]
    ja[0] = ja[0].astype(jnp.bfloat16)
    y_j, st_j = jops.ssd(*ja, chunk=8, interpret=True)
    ta = [torch.from_numpy(a) for a in arrs]
    ta[0] = ta[0].to(torch.bfloat16)
    y_t, st_t = ops.ssd(*ta, chunk=8)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=2e-4,
                               atol=2e-4)


def test_ragged_length_is_refused():
    arrs = [torch.from_numpy(a) for a in _full_inputs(1, 20, 2, 8, 8)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(*arrs, chunk=8)


def test_tensor_core_kernel_marks_its_phases():
    """The tensor-core kernel marks each phase boundary that
    ``benchmarks_torch/ssd_phases.py`` reads once, and gives the stamps
    back through ``ssd_phase_stamps``, both only under the define the
    profiler builds with."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    src = (root / "src/repro_torch/kernels/csrc/ssd_scan_tc.cu").read_text()
    for k in ("0", "1", "2 + wg", "4", "5"):
        assert src.count(f"PHASE({k});") == 1, k
    assert src.count("#ifdef SSD_PHASE_STAMPS") == 2
    assert "extern \"C\" int ssd_phase_stamps(" in src
