"""Flash attention: the port's ``ops.flash_attention`` (its plain version on
the CPU) and ``ref.attention_ref`` against the JAX package's
``ops.flash_attention`` (Pallas kernel in interpret mode) on the cases of
``tests/test_kernels_flash.py``, at its tolerances (2e-5 f32, 2e-2 bf16);
the model's naive and blockwise paths against the reference's.  The CUDA
kernel against its plain version is in ``test_torch_cuda.py``.

Inputs come from numpy with a fixed seed; bf16 inputs are rounded from the
same f32 values in both packages.  The route between the two CUDA kernels
is a pure function of dtype and head dim, tested here; the kernels
themselves run only on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# intra-op threads of parallel test workers only contend for the cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models import attention  # noqa: E402

CASES = [
    # (B, Sq, Skv, H, Hkv, hd, causal, window, dtype, tol)
    (1, 128, 128, 2, 2, 64, True, 0, "float32", 2e-5),
    (2, 256, 256, 4, 2, 64, True, 0, "float32", 2e-5),
    (1, 128, 128, 4, 1, 32, True, 0, "float32", 2e-5),     # MQA
    (1, 256, 256, 2, 2, 64, True, 64, "float32", 2e-5),    # sliding window
    (1, 128, 128, 2, 2, 64, False, 0, "float32", 2e-5),    # bidirectional
    (1, 200, 200, 2, 2, 64, True, 0, "float32", 2e-5),     # ragged blocks
    (1, 128, 128, 2, 2, 128, True, 0, "bfloat16", 2e-2),
    (1, 64, 256, 2, 2, 64, True, 0, "float32", 2e-5),      # Sq != Skv
]


def _qkv(B, Sq, Skv, H, Hkv, hd, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_flash_matches_jax_kernel(case):
    B, Sq, Skv, H, Hkv, hd, causal, window, dtype, tol = case
    q, k, v = _qkv(B, Sq, Skv, H, Hkv, hd)
    q_offset = Skv - Sq if Sq != Skv else 0
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jops.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), interpret=True, **kw),
        np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tdt and tuple(got.shape) == (B, Sq, H, hd)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    flat = lambda t, n: t.transpose(1, 2).reshape(B * n, -1, hd)  # noqa
    ref = attention_ref(flat(tq, H), flat(tk, Hkv), flat(tv, Hkv), **kw)
    ref = ref.reshape(B, H, Sq, hd).transpose(1, 2)
    np.testing.assert_allclose(ref.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal,window,block", [(True, 0, 64),
                                                 (True, 48, 64),
                                                 (False, 0, 48),
                                                 (True, 0, 1024)])
def test_naive_and_blockwise_match_jax(causal, window, block):
    q, k, v = _qkv(2, 112, 112, 4, 2, 32, seed=7)
    kw = dict(causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pairs = [(attention.naive_attention(tq, tk, tv, **kw),
              jattn.naive_attention(jq, jk, jv, **kw)),
             (attention.blockwise_attention(tq, tk, tv, block=block, **kw),
              jattn.blockwise_attention(jq, jk, jv, block=block, **kw))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    # bf16 through the model's naive path: scores and p rounded to bf16
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    got = attention.naive_attention(bq, bk, bv, **kw)
    want = jattn.naive_attention(*(a.astype(jnp.bfloat16)
                                   for a in (jq, jk, jv)), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_attention_inner_q_offset_and_block_match_jax(impl, causal, window):
    """``attention_inner`` with the reference's ``q_offset`` (the 24
    queries are the last of 72 positions) and a ``block`` of 20, which does
    not divide the 72 keys."""
    q, k, v = _qkv(2, 24, 72, 4, 2, 32, seed=9)
    kw = dict(causal=causal, window=window, q_offset=48, impl=impl)
    if impl == "blockwise":
        kw["block"] = 20
    got = attention.attention_inner(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **kw)
    want = jattn.attention_inner(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the offset moves the mask: without it the rows see other keys
    if causal:
        kw.pop("q_offset")
        moved = attention.attention_inner(
            *(torch.from_numpy(a) for a in (q, k, v)), **kw)
        assert not np.allclose(moved.numpy(), np.asarray(want), atol=1e-3)


def test_flash_matches_model_blockwise():
    """As in the reference: the kernel's function agrees with the
    blockwise path."""
    q, k, v = _qkv(2, 128, 128, 4, 2, 64, seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = ops.flash_attention(tq, tk, tv, causal=True)
    b = attention.blockwise_attention(tq, tk, tv, causal=True, block=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_core"),     # hymba, whisper
    (torch.bfloat16, 128, "tensor_core"),    # granite, llama, mixtral
    (torch.bfloat16, 256, "tensor_core"),    # gemma
    (torch.bfloat16, 80, "tensor_core"),     # padded to 128 columns
    (torch.bfloat16, 192, "tensor_core"),
    (torch.float32, 128, "cuda_core"),       # TF32 would break 2e-5
    (torch.float32, 64, "cuda_core"),
    (torch.bfloat16, 16, "cuda_core"),       # the smoke configs' heads
    (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 100, "cuda_core"),      # hd % 8: no TMA stride
    (torch.bfloat16, 264, "cuda_core"),
])
def test_route_from_dtype_and_head_dim(dtype, hd, want):
    assert flash_attention.route(dtype, hd) == want


def test_cpu_bf16_takes_plain_version_without_counting():
    """A CPU tensor whose CUDA route would be the tensor-core kernel takes
    the plain version and counts no launch of either kernel."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((4, 40, 64), (2, 40, 64),
                                             (2, 40, 64)))
    assert flash_attention.route(q.dtype, q.shape[-1]) == "tensor_core"
    before = (flash_attention.launches, flash_attention.tc_launches)
    out = flash_attention.flash_attention_bhsd(q, k, v, causal=True)
    assert torch.equal(out, attention_ref(q, k, v, causal=True))
    assert (flash_attention.launches, flash_attention.tc_launches) == before


def test_cpu_takes_plain_version_and_other_devices_raise():
    q = torch.ones(2, 8, 16)
    k = torch.ones(1, 8, 16)
    before = flash_attention.launches
    out = flash_attention.flash_attention_bhsd(q, k, k, causal=True)
    assert torch.equal(out, attention_ref(q, k, k, causal=True))
    assert flash_attention.launches == before        # no kernel launched
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bhsd(q.to("meta"), k.to("meta"),
                                             k.to("meta"))
