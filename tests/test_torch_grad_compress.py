"""The port's int8 error-feedback gradient compression
(``train/grad_compress.py``) against the JAX package.

- ``quantize`` and the residual on one process against the reference
  compiled (``jax.jit``): codes, scale and residual bit for bit.  XLA
  turns the division by the constant ``qmax`` into a product with its
  reciprocal and ``gf - q * scale`` into one FMA; the port writes both out.
- On four gloo ranks (``torch_dist.compress``) against the reference's
  ``shard_map`` on four host devices (``dist_reference.npz``):
  ``compressed_psum``'s codes, scales and residuals exact and the mean
  gradient within 4 ulps of its dtype (measured: equal; the port sums the
  dequantized values in DP-rank order, as XLA:CPU sums the reference's
  ``psum``); four steps of ``make_dp_train_step`` on a (4, 1) mesh within
  ``TRAIN_TOL``.  A planted fault, the error feedback off, must be caught.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import grad_compress as jgc  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import grad_compress as gc  # noqa: E402

import torch_dist  # noqa: E402

# The DP step against the reference's, aggregates with the tolerances of
# the single-device training check (``chip_smoke.TRAIN_TOL``): the two
# packages' bf16 gradients differ by ~1%, and four AdamW steps from random
# weights amplify that; measured here: loss 1.1e-4, gnorm 1.4e-3, mean
# moves and moments within 0.4% per leaf, and the mean residual within 8%
# (each entry's residual follows the last bits of its gradient).
TRAIN_TOL = dict(loss=2e-2, gnorm=0.3, lr=1e-6, move=0.1, m=0.3, v=0.5,
                 err=0.3)
MEAN_ULPS = 4


def _cases():
    rng = np.random.default_rng(0)
    out = [rng.standard_normal(4096).astype(np.float32) * 3.0,
           (rng.standard_normal((64, 33)) * 2.0 ** -20).astype(np.float32),
           np.zeros(17, np.float32),
           # entries on .5 code boundaries: rounding half to even
           (np.arange(-127, 128, dtype=np.float32) + 0.5).clip(-127, 127)]
    out.append(rng.standard_normal(3000).astype(np.float32)
               * 2.0 ** rng.integers(-12, 12, 3000).astype(np.float32))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_residual_equal_compiled_reference(dtype):
    @jax.jit
    def ref(g, e):
        gf = g.astype(jnp.float32) + e
        q, s = jgc.quantize(gf)
        return q, s, gf - jgc.dequantize(q, s)

    for i, g in enumerate(_cases()):
        e = (np.random.default_rng(i).standard_normal(g.shape)
             * np.abs(g).max() * 1e-3).astype(np.float32)
        jq, js, jr = ref(jnp.asarray(g, getattr(jnp, dtype)), jnp.asarray(e))
        tg = torch.from_numpy(g).to(getattr(torch, dtype))
        gf = tg.float() + torch.from_numpy(e)
        q, s = gc.quantize(gf)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), f"case {i}")
        assert s.item() == float(js), i
        np.testing.assert_array_equal(gc._residual(gf, q, s).numpy(),
                                      np.asarray(jr), f"case {i}")


def test_quantize_roundtrip_and_error_feedback():
    """The reference's own case (``tests/test_substrates.py``)."""
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = gc.quantize(g, 8)
    deq = gc.dequantize(q, s)
    assert float((deq - g).abs().max()) <= float(s) * 0.5 + 1e-6
    err = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, s = gc.quantize(g + err, 8)
        deq = gc.dequantize(q, s)
        err = g + err - deq
        acc = acc + deq
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), atol=float(s))


@pytest.mark.parametrize("arch", sorted(jbase.all_configs()))
def test_wire_bytes_per_step_equal_reference(arch):
    jp = JModel(jbase.get_config(arch)).param_specs()
    tp = Model(base.get_config(arch)).param_specs()
    for kw in ({}, {"enabled": False}, {"bits": 4}):
        assert gc.wire_bytes_per_step(tp, gc.CompressionConfig(**kw)) \
            == jgc.wire_bytes_per_step(jp, jgc.CompressionConfig(**kw))


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gc.make_dp_train_step(None, None, None, gc.CompressionConfig())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist.run("compress", 4, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def no_feedback(tmp_path_factory):
    return torch_dist.run("compress", 4, tmp_path_factory.mktemp("nofb"),
                          fault="no_error_feedback")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_equals_reference(ranks, dtype):
    for rank, r in enumerate(ranks):
        p = r["psum"][dtype]
        assert p["codes_equal"] and p["scale_equal"] and p["err_equal"], \
            (rank, p)
        assert p["mean_dtype"] == f"torch.{dtype}"
        assert p["mean_max_ulps"] <= MEAN_ULPS, (rank, p)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def dp_errors(got: dict, want: dict) -> dict:
    """Each check's error over its ``TRAIN_TOL`` (the worst over steps or
    leaves)."""
    out = {"loss": 0.0, "gnorm": 0.0, "lr": 0.0}
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        for k in out:
            out[k] = max(out[k], _rel(g[k], w[k]) / TRAIN_TOL[k])
    keys = {"move": "mean_abs_delta", "m": "m_mean_abs", "v": "v_mean",
            "err": "err_mean_abs"}
    for name, w in want["leaves"].items():
        g = got["leaves"][name]
        for k, f in keys.items():
            out[k] = max(out.get(k, 0.0), _rel(g[f], w[f]) / TRAIN_TOL[k])
    return out


def test_dp_steps_within_train_tol(ranks):
    _, meta = torch_dist.fixture()
    errs = dp_errors(ranks[0]["dp"], meta["dp"])
    assert max(errs.values()) <= 1.0, errs
    for r in ranks[1:]:                  # the parameters stay replicated
        assert r["dp"]["metrics"] == ranks[0]["dp"]["metrics"]
        for k, v in r["dp"]["params"].items():
            assert torch.equal(v, ranks[0]["dp"]["params"][k]), k


def test_error_feedback_off_is_rejected(no_feedback):
    _, meta = torch_dist.fixture()
    for r in no_feedback:
        assert not r["psum"]["float32"]["err_equal"]
        assert not r["psum"]["bfloat16"]["err_equal"]
    assert dp_errors(no_feedback[0]["dp"], meta["dp"])["err"] > 1.0
