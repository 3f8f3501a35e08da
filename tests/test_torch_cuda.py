"""Tests of the port that need a CUDA card (marked ``cuda``; they skip
without one).  Torch only, so they also run where JAX is not installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

- the RMSNorm kernel against its plain version at the kernel test's
  shapes and tolerances (f32 1e-5, bf16 2e-2), one launch per call;
- the wrapper refuses what the kernel does not take (no fallback);
- the simulator on the card equals the simulator on the CPU, every
  ``SimState`` leaf exactly, for a single point and a mixed-budget batch;
- the flash-attention kernels against their plain version at the flash
  test's cases and tolerances (f32 2e-5, bf16 2e-2) plus head dims 16, 80
  and 256, one launch per call; the tensor-core kernel (bf16, hd 64-256) at
  its own cases (head dims, GQA and MQA, ragged and untiled lengths, the
  window, non-causal, ``q_offset``), each moving its own launch count by
  one; and dense models' ``impl="pallas"`` loss and logits against
  ``impl="naive"`` with one launch per layer, on each route;
- the SSD intra-chunk kernel against its plain version at the SSD test's
  cases and tolerances (f32 1e-4, bf16 5e-2) plus mamba2-1.3b's cell
  shape, one launch per call, and ``ops.ssd`` on the card against the CPU;
  the tensor-core SSD kernel (bf16 x, B, C, Q 64-256) at its own cases
  (B and C by group for 1, 8 and 64 heads, ragged chunk counts, P and N
  padded to a box, P not a multiple of 16 with x loaded by the threads,
  hymba-1.5b's P 50 among them) to 1e-4 of each output's largest entry,
  with the scores rounded to bf16 to 2^-7 (one flipped rounding), each
  moving its own launch count by one, and hymba's cell bitwise equal
  from run to run; f32 inputs on the CUDA-core kernel; and a 2-layer
  mamba2 (d 512, P 64, N 128, chunk 128) with ``impl="pallas"`` against
  ``impl="naive"``;
- the CUDA-core kernels at their tilings' edges: flash f32 at head dims
  16, 48, 80, 128 and 256, lengths off the 64-row tile (1, 65, 130, 777,
  1 500), GQA groups of 1, 4 and 9, the window, non-causal, ``q_offset``,
  unaligned rows (no cp.async) and hd 25, to 2e-5 + 2e-5 |want|; SSD at
  Q 8, 16, 48, 100, 128 (and 256: the row-blocked kernel), P 25, 50, 64,
  100, N 16, 30 (no TMA) and 128, B and C by group for 1, 8 and 64
  heads, bf16 inputs and ``round_scores``, to 1e-4 of each output's
  largest entry (2^-7 rounded), the same bits from run to run; each launch
  moving ``launches`` by one and ``tc_launches`` not at all; and
  hymba-1.5b's width at 2 layers with f32 weights, ``impl="pallas"``
  (two launches of each CUDA-core kernel, nothing else) against
  ``impl="naive"``;
- hymba-1.5b's width at 2 layers with ``impl="pallas"`` (the windowed
  tensor-core flash kernel and the tensor-core SSD kernel, P 50) against
  ``impl="naive"``, by loss, by whole logits (2^-5 of the largest, or
  what one ulp of one input moves naive's own logits by, where that is
  more) and layer by layer; the MoE layer's dispatch
  on the card equal to the
  CPU's (planted ties, drops);
- the wrappers refuse what their kernels do not take;
- the scatter engine (``core/simulator_ref.py``) on the card equals
  itself on the CPU on every step program and the gather engine on the
  card, every state leaf but the engines' own encodings, and its masked
  scatter writes drop on the card as on the CPU (no device-side assert);
- the kernels refuse autograd on the card (``ops.rmsnorm`` still
  differentiates); whisper's and llava's smoke configs with 64-wide heads
  (the encoder's non-causal, ragged self-attention and the decoder's on
  the tensor-core kernel, not the cross-attention) against
  ``impl="naive"``; one training step on the card against the CPU, no
  kernel launched;
- on a process group of one NCCL rank (``chip_smoke.py`` phases 25 and 26
  at 2 layers of hymba-1.5b's width): int8 error-feedback DP steps (the
  loss falls, no kernel launched; the card's codes, scales and residuals
  equal the CPU's bit for bit; the two-level all-reduce on a (1, 1) mesh
  is the identity), and the one-stage pipeline against ``Model.loss``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import carry  # noqa: E402
from repro_torch.core import simulator, sweep  # noqa: E402
from repro_torch.core.constants import Fabric, MacMode, SimParams  # noqa: E402
from repro_torch.kernels import flash_attention, ops, rmsnorm  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import (attention_ref, rmsnorm_ref,  # noqa: E402
                                     ssd_intra_chunk_ref)

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


FLASH_CASES = [
    # (BH, BHkv, Sq, Skv, hd, causal, window, q_offset, dtype, tol)
    (2, 2, 128, 128, 64, True, 0, 0, torch.float32, 2e-5),
    (8, 4, 256, 256, 64, True, 0, 0, torch.float32, 2e-5),
    (4, 1, 128, 128, 32, True, 0, 0, torch.float32, 2e-5),      # MQA
    (2, 2, 256, 256, 64, True, 64, 0, torch.float32, 2e-5),     # window
    (2, 2, 128, 128, 64, False, 0, 0, torch.float32, 2e-5),     # bidirect.
    (2, 2, 200, 200, 64, True, 0, 0, torch.float32, 2e-5),      # ragged
    (2, 2, 128, 128, 128, True, 0, 0, torch.bfloat16, 2e-2),
    (2, 2, 64, 256, 64, True, 0, 192, torch.float32, 2e-5),     # Sq != Skv
    (4, 2, 100, 100, 16, True, 0, 0, torch.float32, 2e-5),      # smoke hd
    (3, 1, 70, 90, 80, False, 30, 10, torch.float32, 2e-5),     # hd padded
    (4, 4, 300, 300, 256, True, 0, 0, torch.bfloat16, 2e-2),    # gemma hd
]


def _qkv(BH, BHkv, Sq, Skv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(device, dtype)
    return mk(BH, Sq, hd), mk(BHkv, Skv, hd), mk(BHkv, Skv, hd)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain_version(case, cuda):
    BH, BHkv, Sq, Skv, hd, causal, window, q_offset, dtype, tol = case
    q, k, v = _qkv(BH, BHkv, Sq, Skv, hd, dtype, cuda)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


TC_CASES = [
    # (BH, BHkv, Sq, Skv, hd, causal, window, q_offset): bf16, tol 2e-2
    (2, 2, 256, 256, 64, True, 0, 0),           # hd 64
    (2, 2, 256, 256, 128, True, 0, 0),          # hd 128
    (2, 2, 256, 256, 256, True, 0, 0),          # hd 256 (64-key tiles)
    (8, 2, 256, 256, 128, True, 0, 0),          # GQA
    (4, 1, 256, 256, 64, True, 0, 0),           # MQA
    (2, 2, 200, 200, 128, True, 0, 0),          # ragged Sq = Skv
    (2, 2, 128, 300, 64, True, 0, 172),         # Skv not a tile multiple
    (2, 2, 384, 384, 256, True, 0, 0),          # ragged 64-key tiles
    (2, 2, 512, 512, 64, True, 128, 0),         # window
    (3, 1, 300, 300, 128, True, 100, 0),        # window, GQA, ragged
    (2, 2, 200, 200, 128, False, 0, 0),         # non-causal
    (2, 2, 128, 512, 128, True, 0, 384),        # Sq != Skv, q_offset
    (2, 1, 96, 200, 256, False, 40, 60),        # window without causal
    (2, 2, 130, 130, 80, True, 0, 0),           # head padded to 128
]


@pytest.mark.parametrize("case", TC_CASES)
def test_flash_tensor_core_kernel_matches_plain_version(case, cuda):
    BH, BHkv, Sq, Skv, hd, causal, window, q_offset = case
    q, k, v = _qkv(BH, BHkv, Sq, Skv, hd, torch.bfloat16, cuda, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert flash_attention.route(q.dtype, hd) == "tensor_core"
    before = (flash_attention.launches, flash_attention.tc_launches)
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.tc_launches) \
        == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


FLASH_F32_EDGES = [
    # (BH, BHkv, Sq, Skv, hd, causal, window, q_offset): f32, CUDA cores
    (4, 4, 1, 1, 16, True, 0, 0),               # one row, one key
    (4, 1, 1, 1500, 128, True, 0, 1499),        # one row past 1 499 keys
    (9, 1, 1500, 1500, 48, True, 0, 0),         # GQA 9, hd padded to 64
    (2, 2, 1500, 1500, 80, False, 0, 0),        # non-causal, hd 80
    (4, 4, 130, 130, 256, True, 0, 0),          # hd 256: 256 threads
    (8, 2, 777, 777, 128, True, 300, 0),        # window, GQA 4
    (2, 2, 100, 1500, 64, True, 200, 1400),     # q_offset and window
    (3, 3, 65, 1, 16, False, 0, 0),             # one key, non-causal
    (4, 4, 1, 1500, 32, False, 0, 0),           # one row, non-causal
    (3, 3, 200, 200, 25, True, 0, 0),           # hd 25: no cp.async
]


@pytest.mark.parametrize("case", FLASH_F32_EDGES)
def test_flash_cuda_core_kernel_at_its_tiling_edges(case, cuda):
    BH, BHkv, Sq, Skv, hd, causal, window, q_offset = case
    q, k, v = _qkv(BH, BHkv, Sq, Skv, hd, torch.float32, cuda, seed=2)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert flash_attention.route(q.dtype, hd) == "cuda_core"
    before = (flash_attention.launches, flash_attention.tc_launches)
    got = flash_attention.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.tc_launches) \
        == (before[0] + 1, before[1])
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v, **kw).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_flash_cuda_core_kernel_takes_unaligned_rows(cuda):
    """q 4 bytes into its storage: the tiles are filled by the threads,
    not cp.async, with the same result."""
    q, k, v = _qkv(2, 2, 300, 300, 128, torch.float32, cuda, seed=3)
    flat = torch.empty(q.numel() + 1, device=cuda)
    qm = flat[1:].view(q.shape).copy_(q)
    before = flash_attention.launches
    got = flash_attention.flash_attention_bhsd(qm, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_flash_f32_takes_cuda_core_kernel(cuda):
    q, k, v = _qkv(2, 2, 128, 128, 128, torch.float32, cuda)
    before = (flash_attention.launches, flash_attention.tc_launches)
    got = flash_attention.flash_attention_bhsd(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.tc_launches) \
        == (before[0] + 1, before[1])
    np.testing.assert_allclose(got.cpu().numpy(),
                               attention_ref(q, k, v).cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_flash_tensor_core_refuses_misaligned_inputs(cuda):
    """TMA needs 16-byte aligned tensors: a view 2 bytes into its storage
    raises (no other kernel takes it instead)."""
    q, k, v = _qkv(2, 2, 64, 64, 64, torch.bfloat16, cuda)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    qm = flat[1:].view(q.shape).copy_(q)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention_bhsd(qm, k, v)
    assert flash_attention.launches == before


def test_flash_wrapper_refuses_unsupported_inputs(cuda):
    q, k, v = _qkv(2, 2, 32, 32, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        flash_attention.flash_attention_bhsd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bhsd(q, k.cpu(), v)   # mixed devices
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bhsd(q.transpose(1, 2).contiguous()
                                             .transpose(1, 2), k, v)
    big = torch.zeros(2, 8, 320, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_bhsd(big, big, big)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention.flash_attention_bhsd(q[:1].repeat(3, 1, 1), k, v)


def test_dense_model_pallas_loss_matches_naive_on_card(cuda):
    """The smoke config's bf16 heads (hd 16) take the CUDA-core kernel."""
    from repro_torch.configs.base import get_config
    _pallas_matches_naive(get_config("granite-8b").smoke(), cuda, tc=False)


def test_dense_model_tensor_core_route_matches_naive_on_card(cuda):
    """With 64-wide heads every layer takes the tensor-core kernel."""
    from repro_torch.configs.base import get_config
    _pallas_matches_naive(get_config("granite-8b").smoke().scaled(
        head_dim=64), cuda, tc=True)


def _pallas_matches_naive(cfg, cuda, tc: bool):
    from repro_torch.models.model import Model
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 96))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    before = (flash_attention.launches, flash_attention.tc_launches)
    got = Model(cfg, impl="pallas").loss(params, batch)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.tc_launches) == (
        before[0] + cfg.n_layers, before[1] + int(tc) * cfg.n_layers)
    want = Model(cfg, impl="naive").loss(params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-4)
    # the loss of random weights sits near ln(vocab) whatever attention
    # does; the logits are what it determines (2^-5 of the largest: flipped
    # bf16 roundings of activations, as in test_torch_model.py)
    from repro_torch.models import transformer as tf
    lg = {impl: tf.lm_logits(cfg, params, tf.lm_hidden(
        cfg, params, toks, impl=impl)).float().cpu().numpy()
        for impl in ("pallas", "naive")}
    np.testing.assert_allclose(lg["pallas"], lg["naive"], rtol=0,
                               atol=2.0 ** -5 * np.abs(lg["naive"]).max())


SSD_CASES = [
    # (BH, c, Q, P, N, dtype, tol)
    (2, 2, 16, 8, 16, torch.float32, 1e-4),
    (4, 4, 32, 16, 32, torch.float32, 1e-4),
    (1, 1, 64, 64, 128, torch.float32, 1e-4),
    (2, 2, 16, 8, 16, torch.bfloat16, 5e-2),
    (2, 3, 8, 16, 16, torch.float32, 1e-4),       # smoke chunk 8
]


def _ssd_inputs(BH, c, Q, P, N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    x = f(rng.standard_normal((BH, c, Q, P))).to(dtype)
    dt = f(np.log1p(np.exp(rng.standard_normal((BH, c, Q)))))
    A = f(-np.exp(0.3 * rng.standard_normal(BH)))
    B = f(rng.standard_normal((BH, c, Q, N))).to(dtype)
    C = f(rng.standard_normal((BH, c, Q, N))).to(dtype)
    return x, dt, A, B, C


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_version(case, cuda):
    BH, c, Q, P, N, dtype, tol = case
    args = _ssd_inputs(BH, c, Q, P, N, dtype, cuda)
    before = ssd_scan.launches
    got = ssd_scan.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ssd_intra_chunk_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol, atol=tol)


def test_ssd_kernel_matches_plain_version_at_mamba_shape(cuda):
    """mamba2-1.3b's cell (Q 128, P 64, N 128) with unit-normal inputs.
    Each y entry sums 128 x 128 products of magnitude ~10 in another order
    than the plain version, so the f32 difference scales with the outputs'
    size, not with each entry (an elementwise 1e-4 bound failed at 5 of
    122 880 entries near cancellation, by 1.6e-4 absolute): held to 1e-4 of
    each output's largest entry."""
    args = _ssd_inputs(3, 5, 128, 64, 128, torch.float32, cuda)
    before = ssd_scan.launches
    got = ssd_scan.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    for g, w in zip(got, ssd_intra_chunk_ref(*args)):
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def test_full_ssd_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    b, l, h, p, n = 1, 256, 4, 64, 128
    arrs = [(0.5 * rng.standard_normal((b, l, h, p))),
            np.log1p(np.exp(rng.standard_normal((b, l, h)))),
            -np.exp(0.2 * rng.standard_normal(h)),
            0.3 * rng.standard_normal((b, l, n)),
            0.3 * rng.standard_normal((b, l, n))]
    ts = [torch.from_numpy(a.astype(np.float32)) for a in arrs]
    before = ssd_scan.launches
    y, st = ops.ssd(*(t.to(cuda) for t in ts), chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    # the chunk states are rounded to bf16 inside ops.ssd, so the two
    # intra-chunk versions' f32 differences can flip a rounding: 2^-7 of
    # each output's largest entry
    y_c, st_c = ops.ssd(*ts, chunk=128)
    for g, w in ((y, y_c), (st, st_c)):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=2.0 ** -7 * float(w.abs().max()))


def test_ssd_wrapper_refuses_unsupported_inputs(cuda):
    x, dt, A, B, C = _ssd_inputs(2, 2, 16, 8, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        ssd_scan.ssd_intra_chunk(x.half(), dt, A, B, C)
    with pytest.raises(ValueError):
        ssd_scan.ssd_intra_chunk(x, dt.cpu(), A, B, C)
    with pytest.raises(ValueError):
        ssd_scan.ssd_intra_chunk(x, dt, A, B[..., :8], C)
    big = _ssd_inputs(1, 1, 512, 64, 128, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan.ssd_intra_chunk(*big)


SSD_TC_CASES = [
    # (groups, heads, c, Q, P, N, round_scores): bf16 x, B, C
    (3, 1, 5, 64, 64, 64, False),
    (2, 8, 3, 128, 64, 128, False),
    (2, 8, 3, 128, 64, 128, True),
    (1, 64, 2, 128, 128, 256, False),
    (3, 8, 1, 256, 64, 128, True),
    (1, 64, 3, 128, 64, 128, True),
    (3, 1, 2, 64, 32, 48, False),                 # P and N padded to a box
    (1, 2, 1, 192, 80, 16, True),
    # P not a multiple of 16: x loaded by the threads, not TMA
    (2, 64, 2, 128, 50, 16, False),               # hymba-1.5b's cell
    (2, 64, 2, 128, 50, 16, True),
    (1, 8, 3, 64, 24, 16, False),
    (1, 8, 3, 64, 24, 16, True),
    (3, 2, 2, 128, 100, 32, False),               # two boxes
    (3, 2, 2, 128, 100, 32, True),
    (1, 2, 1, 256, 130, 16, False),               # three boxes, Q 256
    (1, 2, 1, 256, 130, 16, True),
    (1, 4, 2, 256, 250, 32, False),               # four boxes, Q 256
    (1, 4, 2, 256, 250, 32, True),
    (1, 2, 1, 128, 200, 16, False),               # four boxes, Q 128
    (1, 2, 1, 128, 200, 16, True),
]


def _ssd_tc_inputs(G, heads, c, Q, P, N, device, seed=1):
    x, dt, A, B, C = _ssd_inputs(G * heads, c, Q, P, N, torch.bfloat16,
                                 device, seed)
    return x, dt, A, B[:G].contiguous(), C[:G].contiguous()


@pytest.mark.parametrize("case", SSD_TC_CASES)
def test_ssd_tensor_core_kernel_matches_plain_version(case, cuda):
    G, heads, c, Q, P, N, rs = case
    args = _ssd_tc_inputs(G, heads, c, Q, P, N, cuda)
    assert ssd_scan.route(tuple(t.dtype for t in args), Q, P, N) \
        == "tensor_core"
    before = (ssd_scan.launches, ssd_scan.tc_launches)
    got = ssd_scan.ssd_intra_chunk(*args, heads=heads, round_scores=rs)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.tc_launches) \
        == (before[0] + 1, before[1] + 1)
    x, dt, A, B, C = args
    want = ssd_intra_chunk_ref(x, dt, A, B.repeat_interleave(heads, 0),
                               C.repeat_interleave(heads, 0),
                               round_scores=rs)
    # scores rounded to bf16 on both sides: a last-place difference of
    # their f32 sums can round one score the other way (2^-8 of a term)
    tol = 2.0 ** -7 if rs else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


def test_ssd_tensor_core_thread_loaded_x_is_deterministic(cuda):
    """hymba-1.5b's cell (P 50: x stored to shared memory by the threads)
    twice gives bitwise equal outputs: wgmma reading x before the proxy
    fence has made those stores visible would differ from run to run."""
    G, heads, c, Q, P, N = 2, 64, 32, 128, 50, 16
    args = _ssd_tc_inputs(G, heads, c, Q, P, N, cuda)
    assert ssd_scan.route(tuple(t.dtype for t in args), Q, P, N) \
        == "tensor_core"
    runs = [ssd_scan.ssd_intra_chunk(*args, heads=heads, round_scores=True)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_ssd_f32_takes_cuda_core_kernel(cuda):
    args = _ssd_inputs(2, 2, 128, 64, 128, torch.float32, cuda)
    before = (ssd_scan.launches, ssd_scan.tc_launches)
    got = ssd_scan.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.tc_launches) \
        == (before[0] + 1, before[1])
    for g, w in zip(got, ssd_intra_chunk_ref(*args)):
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


SSD_CC_CASES = [
    # (groups, heads, c, Q, P, N, dtype, round_scores): the CUDA-core route
    (2, 1, 3, 8, 25, 16, torch.float32, False),
    (1, 8, 2, 16, 50, 128, torch.float32, False),
    (1, 64, 2, 48, 25, 16, torch.float32, False),
    (2, 8, 2, 128, 50, 16, torch.float32, False),   # hymba's f32 cell
    (1, 64, 2, 128, 64, 128, torch.float32, False),  # mamba2's, by group
    (1, 8, 2, 128, 25, 128, torch.float32, True),
    (1, 4, 2, 100, 100, 30, torch.float32, False),   # N % 4: no TMA
    (2, 8, 2, 48, 50, 16, torch.bfloat16, True),     # Q < 64: not tc
    (1, 8, 2, 16, 64, 128, torch.bfloat16, False),
    (1, 2, 1, 256, 50, 16, torch.float32, False),    # the row-blocked kernel
]


@pytest.mark.parametrize("case", SSD_CC_CASES)
def test_ssd_cuda_core_kernel_at_its_tiling_edges(case, cuda):
    G, heads, c, Q, P, N, dtype, rs = case
    x, dt, A, B, C = _ssd_inputs(G * heads, c, Q, P, N, dtype, cuda, seed=4)
    args = (x, dt, A, B[:G].contiguous(), C[:G].contiguous())
    assert ssd_scan.route(tuple(t.dtype for t in args), Q, P, N) \
        == "cuda_core"
    before = (ssd_scan.launches, ssd_scan.tc_launches)
    runs = [ssd_scan.ssd_intra_chunk(*args, heads=heads, round_scores=rs)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.tc_launches) \
        == (before[0] + 2, before[1])
    want = ssd_intra_chunk_ref(x, dt, A, args[3].repeat_interleave(heads, 0),
                               args[4].repeat_interleave(heads, 0),
                               round_scores=rs)
    tol = 2.0 ** -7 if rs else 1e-4
    for g, again, w in zip(*runs, want):
        assert torch.equal(g, again)          # the same bits, run to run
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


def test_ssd_tensor_core_refuses_misaligned_inputs(cuda):
    """TMA needs 16-byte aligned, contiguous x, B, C: a view 2 bytes into
    its storage, or a non-contiguous one, raises (no other kernel takes it
    instead)."""
    x, dt, A, B, C = _ssd_tc_inputs(2, 2, 1, 64, 64, 64, cuda)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    xm = flat[1:].view(x.shape).copy_(x)
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan.ssd_intra_chunk(xm, dt, A, B, C, heads=2)
    xt = x.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan.ssd_intra_chunk(xt, dt, A, B, C, heads=2)
    assert ssd_scan.launches == before


def test_mamba_pallas_matches_naive_on_card(cuda):
    """2 layers at d 512 (8 heads of P 64, N 128, chunk 128): every layer
    takes the tensor-core SSD kernel once."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cfg = get_config("mamba2-1.3b").scaled(n_layers=2, d_model=512,
                                           vocab=4096)
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    before = (ssd_scan.launches, ssd_scan.tc_launches)
    got = Model(cfg, impl="pallas").loss(params, batch)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.tc_launches) \
        == (before[0] + 2, before[1] + 2)
    want = Model(cfg, impl="naive").loss(params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-4)
    lg = {impl: tf.lm_logits(cfg, params, tf.lm_hidden(
        cfg, params, toks, impl=impl)).float()[..., :cfg.vocab].cpu().numpy()
        for impl in ("pallas", "naive")}
    np.testing.assert_allclose(lg["pallas"], lg["naive"], rtol=0,
                               atol=2.0 ** -5 * np.abs(lg["naive"]).max())


def test_hymba_f32_pallas_matches_naive_on_card(cuda):
    """hymba-1.5b's width at 2 layers with f32 weights: attention and the
    SSM see f32 inputs, so ``impl="pallas"`` launches the CUDA-core flash
    kernel twice (hd 64, the 2048-token window) and the CUDA-core SSD
    kernel twice (P 50, N 16, B and C by group), nothing else.  Both sides
    compute every product in f32: logits to 2^-8 of the largest, the loss
    to rel 1e-4, as ``chip_smoke.py`` phase 34 holds them."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cfg = get_config("hymba-1.5b").scaled(n_layers=2, vocab=4096)
    f32 = torch.float32
    params = Model(cfg, param_dtype=f32).init(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 384))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    kmods = (flash_attention, ssd_scan, rmsnorm)
    before = [m.launches for m in kmods] + [flash_attention.tc_launches,
                                            ssd_scan.tc_launches]
    with torch.no_grad():
        got = tf.lm_logits(cfg, params, tf.lm_hidden(
            cfg, params, toks, impl="pallas")).float()[..., :cfg.vocab]
        torch.cuda.synchronize()
        after = [m.launches for m in kmods] + [flash_attention.tc_launches,
                                               ssd_scan.tc_launches]
        want = tf.lm_logits(cfg, params, tf.lm_hidden(
            cfg, params, toks, impl="naive")).float()[..., :cfg.vocab]
        loss = [float(Model(cfg, impl=impl, param_dtype=f32).loss(
            params, batch)) for impl in ("pallas", "naive")]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 0, 0, 0]
    w = want.cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), w, rtol=0,
                               atol=2.0 ** -8 * np.abs(w).max())
    np.testing.assert_allclose(loss[0], loss[1], rtol=1e-4)


# (batch row, position, feature) of the embedding entries that
# ``test_hymba_pallas_matches_naive_on_card`` moves by one bf16 ulp
HYMBA_NUDGES = ((0, 0, 0), (1, 100, 5), (0, 255, 17), (1, 7, 900))


def test_hymba_pallas_matches_naive_on_card(cuda, monkeypatch):
    """hymba-1.5b's width at 2 layers: every layer launches the
    tensor-core flash kernel once (hd 64, the window) and the tensor-core
    SSD kernel once (P 50, x loaded by the threads), never the CUDA-core
    SSD kernel.  The loss is held to naive's; the whole logits to naive's
    at 2^-5 of the largest, or at the one-ulp sensitivity where that is
    larger: the most naive's own logits move when one embedding entry (at
    each of ``HYMBA_NUDGES``) moves by one bf16 ulp.  At this seed one
    such ulp moves single logits by more than 2^-5, so any two right SSD
    versions may differ by as much; the kernel and its plain version are
    both held.  Each layer's sequence mixer (attention and SSM heads) is
    held to naive's on naive's residual stream at 2^-5 of its largest
    entry, as ``chip_smoke.py`` holds hymba."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cfg = get_config("hymba-1.5b").scaled(n_layers=2, vocab=4096)
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    before = (flash_attention.tc_launches, ssd_scan.launches,
              ssd_scan.tc_launches)
    got = Model(cfg, impl="pallas").loss(params, batch)
    torch.cuda.synchronize()
    assert (flash_attention.tc_launches, ssd_scan.launches,
            ssd_scan.tc_launches) == (before[0] + 2, before[1] + 2,
                                      before[2] + 2)
    want = Model(cfg, impl="naive").loss(params, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=5e-4)

    def logits(impl):
        with torch.no_grad():
            return tf.lm_logits(cfg, params, tf.lm_hidden(
                cfg, params, toks, impl=impl)).float()[..., :cfg.vocab]

    naive = logits("naive")
    rel = lambda lg: float((lg - naive).abs().max() / naive.abs().max())  # noqa
    real_embed, sensitivity = tf.embed, 0.0
    for b, s, j in HYMBA_NUDGES:
        def nudged(emb, tokens, b=b, s=s, j=j):
            x = real_embed(emb, tokens).clone()
            x[b, s, j] = x[b, s, j] * (1 + 2.0 ** -7)
            return x
        with monkeypatch.context() as m:
            m.setattr(tf, "embed", nudged)
            sensitivity = max(sensitivity, rel(logits("naive")))
    errs = {"kernel": rel(logits("pallas"))}
    with monkeypatch.context() as m:
        m.setattr(ssd_scan, "ssd_intra_chunk", lambda x, dt, A, B, C, heads,
                  round_scores: ssd_intra_chunk_ref(
                      x, dt, A, B.repeat_interleave(heads, 0),
                      C.repeat_interleave(heads, 0),
                      round_scores=round_scores))
        errs["plain version"] = rel(logits("pallas"))
    limit = max(2.0 ** -5, sensitivity)
    print(f"hymba 2 layers, whole logits vs naive (of the largest): {errs}, "
          f"one-ulp sensitivity {sensitivity}, limit {limit}")
    for name, err in errs.items():
        assert err <= limit, (name, err, limit)
    x = tf.embed(params["embed"], toks).to(torch.bfloat16)
    pos = torch.arange(x.shape[1], device=cuda)
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp = tf.layer_params(params["layers"], i)
            mix = {impl: tf.mixer(cfg, x, lp, positions=pos, causal=True,
                                  impl=impl).float()
                   for impl in ("naive", "pallas")}
            w = mix["naive"].cpu().numpy()
            np.testing.assert_allclose(mix["pallas"].cpu().numpy(), w,
                                       rtol=0,
                                       atol=2.0 ** -5 * np.abs(w).max())
            x = x + mix["naive"].to(x.dtype)
            if "ffn" in lp:
                x = x + tf.ffn(cfg, x, lp)


def test_moe_dispatch_on_card_equals_cpu(cuda):
    """The MoE layer on the card: the same top-k experts and dropped
    assignments as on the CPU for the same bf16 router probabilities
    (planted ties included), and the layer's output within 2^-7 of the
    CPU's largest entry (cuBLAS sums in another order)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config("mixtral-8x22b").smoke()
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                             * s[-2] ** -0.5).to(torch.bfloat16)
         for k, s in moe.moe_shapes(cfg).items()}
    p["router"][:, 2] = p["router"][:, 1]              # tied experts
    x = torch.from_numpy(rng.standard_normal((2, 256, cfg.d_model))
                         .astype(np.float32) + 2.0).to(torch.bfloat16)
    probs = torch.softmax(
        (x.reshape(-1, cfg.d_model) @ p["router"]).float(), -1)
    out = {}
    for dev in ("cpu", cuda):
        _, experts = moe.top_k(probs.to(dev), cfg.top_k)
        plan = moe.dispatch_plan(experts, cfg.n_experts,
                                 moe.capacity(cfg, probs.shape[0]))
        y = moe.moe_ff(x.to(dev), {k: v.to(dev) for k, v in p.items()}, cfg)
        out[str(dev)] = (experts.cpu(), moe.dropped(plan).cpu(),
                         y.float().cpu())
    (e0, d0, y0), (e1, d1, y1) = out.values()
    assert torch.equal(e0, e1) and torch.equal(d0, d1) and len(d0) > 0
    assert float((y0 - y1).abs().max()) <= 2.0 ** -7 * float(y0.abs().max())


# ---- the scatter engine on the card

SCATTER_PROGRAMS = ("wireless", "single", "mem_on", "multicast", "phy_on",
                    "living")


def _scatter_case(case, cycles=200):
    import pathlib
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke, chip_smoke.scatter_case(case, cycles)


@pytest.mark.parametrize("case", SCATTER_PROGRAMS)
def test_scatter_engine_on_card_equals_cpu(case, cuda):
    from repro_torch.core import simulator_ref
    _, (topo, rt, tt, phy, sim, spec) = _scatter_case(case)
    got = carry.state_to_numpy(simulator_ref.run(simulator_ref.pack(
        topo, rt, tt, phy, sim, phy_spec=spec, device=cuda)))
    want = carry.state_to_numpy(simulator_ref.run(simulator_ref.pack(
        topo, rt, tt, phy, sim, phy_spec=spec, device="cpu")))
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["flits_inj"]) > 0


@pytest.mark.parametrize("case", ("interposer", "token", "mem_on",
                                  "multicast"))
def test_scatter_engine_on_card_equals_gather_engine(case, cuda):
    from repro_torch.core import simulator_ref
    cs, (topo, rt, tt, phy, sim, spec) = _scatter_case(case)
    r = simulator_ref.run(simulator_ref.pack(topo, rt, tt, phy, sim,
                                             phy_spec=spec, device=cuda))
    g = simulator.run(simulator.pack(topo, rt, tt, phy, sim, phy_spec=spec,
                                     device=cuda))
    assert cs.state_diff(r, g) == []


def test_scatter_masked_writes_drop_on_card(cuda):
    """Targets past either end (a wrapped negative, the spare slot) on the
    card: no device-side assert, the CPU's result."""
    from repro_torch.core import simulator_ref
    rng = np.random.default_rng(3)
    base = torch.from_numpy(rng.integers(-9, 9, (2, 6, 5)).astype(np.int32))
    i = torch.from_numpy(rng.integers(-8, 9, (2, 40)))
    j = torch.from_numpy(rng.integers(-6, 7, (2, 40)))
    val = torch.from_numpy(rng.integers(-9, 9, (2, 40)).astype(np.int32))
    for how in ("add", "min"):
        want = simulator_ref._put(base, simulator_ref._index((6, 5), (i, j)),
                                  val, how)
        got = simulator_ref._put(
            base.to(cuda), simulator_ref._index((6, 5), (i.to(cuda),
                                                         j.to(cuda))),
            val.to(cuda), how)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


# --------------------------------------------------------------------------
# the kernels refuse autograd on the card; the encoder-decoder and the VLM
# on the tensor-core route; a training step on the card
# --------------------------------------------------------------------------

def test_kernels_refuse_autograd_on_the_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 128, 64, generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    with pytest.raises(RuntimeError, match="blockwise"):
        flash_attention.flash_attention_bhsd(q.requires_grad_(), k, v)
    with torch.no_grad():
        flash_attention.flash_attention_bhsd(q, k, v)
    assert flash_attention.launches == before + 1
    x = torch.randn(2, 1, 64, 64, generator=g, device=cuda).to(torch.bfloat16)
    dt = torch.rand(2, 1, 64, generator=g, device=cuda)
    A = -torch.rand(2, generator=g, device=cuda)
    B, C = (torch.randn(2, 1, 64, 16, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    with pytest.raises(RuntimeError, match="blockwise"):
        ssd_scan.ssd_intra_chunk(x, dt.requires_grad_(), A, B, C)
    xr = torch.randn(4, 64, generator=g, device=cuda)
    w = torch.ones(64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="ops.rmsnorm"):
        rmsnorm.rmsnorm_2d(xr, w)
    ops.rmsnorm(xr, w).sum().backward()
    assert w.grad is not None


@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-mistral-7b"])
def test_encdec_and_vlm_pallas_match_naive_on_card(name, cuda):
    """64-wide heads: the self-attention of the encoder (non-causal,
    ragged: 40 frames) and of the decoder take the tensor-core kernel, the
    cross-attention does not; loss and text logits against naive."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    cfg = get_config(name).smoke().scaled(
        head_dim=64, audio_frames_default=40, vlm_patches_default=24)
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device=cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 72))).to(cuda)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    extra = {"encdec": ("frames", cfg.audio_frames_default),
             "vlm": ("patches", cfg.vlm_patches_default)}[cfg.family]
    batch[extra[0]] = torch.from_numpy(rng.standard_normal(
        (2, extra[1], cfg.d_model)).astype(np.float32)).to(cuda)
    layers = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec"
                             else 0)
    before = flash_attention.tc_launches
    with torch.no_grad():
        got = Model(cfg, impl="pallas").loss(params, batch)
        torch.cuda.synchronize()
        assert flash_attention.tc_launches == before + layers
        want = Model(cfg, impl="naive").loss(params, batch)
        np.testing.assert_allclose(float(got), float(want), rtol=5e-4)
        kw = {extra[0]: batch[extra[0]]}
        lg = {impl: tf.lm_logits(cfg, params, tf.lm_hidden(
            cfg, params, toks, impl=impl, **kw)).float().cpu().numpy()
            for impl in ("pallas", "naive")}
    np.testing.assert_allclose(lg["pallas"], lg["naive"], rtol=0,
                               atol=2.0 ** -5 * np.abs(lg["naive"]).max())


def test_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_step`` of hymba's smoke config from the same
    weights on the card and on the CPU: loss and gradient norm (bf16
    activations summed in other orders: rel 5e-4 and 1e-2), and no kernel
    of this repository launched."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.models.model import Model
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optimizer import AdamW
    cfg = get_config("hymba-1.5b").smoke()
    model = Model(cfg, xent_chunk=16)
    opt = AdamW(lr=1e-3)
    batch = model.make_inputs(ShapeSpec("t", 32, 4, "train"),
                              torch.Generator().manual_seed(1))
    out = {}
    counts = (flash_attention.launches, ssd_scan.launches, rmsnorm.launches)
    for dev in ("cpu", cuda):
        params = carry.params_from_jax(carry.numpy_params(cfg, 0), device=dev)
        _, _, m = make_train_step(model, opt)(
            params, opt.init(params), {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = {k: float(v) for k, v in m.items()}
    assert (flash_attention.launches, ssd_scan.launches,
            rmsnorm.launches) == counts
    a, b = out["cpu"], out[str(cuda)]
    assert b["loss"] == pytest.approx(a["loss"], rel=5e-4)
    assert b["gnorm"] == pytest.approx(a["gnorm"], rel=1e-2)
    assert b["lr"] == a["lr"]


@pytest.fixture(scope="module")
def one_rank():
    """A process group of one rank on the card (NCCL) and its host mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    dev = mesh.init_distributed(device="cuda")
    yield mesh.make_host_mesh(device=dev), dev
    mesh.shutdown()


def _hymba_2l(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import Model
    cfg = get_config("hymba-1.5b").scaled(n_layers=2)
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                  global_batch=8))
    return cfg, params, lambda i: {k: torch.from_numpy(v).to(dev)
                                   for k, v in data.batch(i).items()}


def test_compressed_dp_on_card(one_rank):
    """Phase 25 at 2 layers: four int8 error-feedback DP steps of
    hymba-1.5b's width on one NCCL rank (the loss falls on a repeated
    batch, no kernel of this repository launches); the card's codes,
    scales and residuals of a step's gradients equal the CPU's bit for
    bit; ``hierarchical_grad_reduce`` on a (1, 1) mesh is the identity."""
    from repro_torch.interconnect import scheduler
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.loop import value_and_grad
    from repro_torch.train.optimizer import AdamW
    host, dev = one_rank
    cfg, params, batch = _hymba_2l(dev)
    model = Model(cfg, xent_chunk=128)
    opt = AdamW(lr=1e-3)
    st, err = opt.init(params), gc.init_error(params)
    fn = gc.make_dp_train_step(model, opt, host, gc.CompressionConfig(),
                               device=dev)
    counts = (flash_attention.launches, ssd_scan.launches, rmsnorm.launches)
    losses = []
    for _ in range(4):
        params, st, err, m = fn(params, st, err, batch(0))
        losses.append(float(m["loss"]))
    assert (flash_attention.launches, ssd_scan.launches,
            rmsnorm.launches) == counts
    assert losses[-1] < losses[0], losses
    assert any(float(e.abs().max()) > 0 for _, e in tf.leaves(err))
    _, grads = value_and_grad(model.loss, params, batch(1))
    for g, (name, e) in zip(grads, tf.leaves(err)):
        gf = g.float() + e
        q, s = gc.quantize(gf)
        cq, cs = gc.quantize(gf.cpu())
        assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs), name
        assert torch.equal(gc._residual(gf, q, s).cpu(),
                           gc._residual(gf.cpu(), cq, cs)), name
    tree = tf.unflatten(zip((k for k, _ in tf.leaves(params)), grads))
    pd = mesh.make_mesh((1, 1), ("pod", "data"), device=dev)
    out = scheduler.hierarchical_grad_reduce(tree, mesh=pd)
    for (k, a), (_, b) in zip(tf.leaves(tree), tf.leaves(out)):
        assert torch.equal(a, b), k


def test_one_stage_pipeline_on_card_matches_model_loss(one_rank):
    """Phase 26 at 2 layers: ``make_pp_loss`` with one stage and four
    microbatches against ``Model.loss`` on the card, loss and gradients
    (``chip_smoke.PP_TOL``: the microbatches' products may take other
    cuBLAS kernels, and autograd adds the four gradients in bf16)."""
    from repro_torch.models.model import Model
    from repro_torch.train import pipeline
    from repro_torch.train.loop import value_and_grad
    host, dev = one_rank
    cfg, params, batch = _hymba_2l(dev)
    b = batch(0)
    counts = (flash_attention.launches, ssd_scan.launches, rmsnorm.launches)
    pl, pg = value_and_grad(pipeline.make_pp_loss(
        cfg, host, n_stages=1, n_micro=4, xent_chunk=128, device=dev),
        params, b)
    sl, sg = value_and_grad(Model(cfg, xent_chunk=128).loss, params, b)
    assert (flash_attention.launches, ssd_scan.launches,
            rmsnorm.launches) == counts
    assert float(pl) == pytest.approx(float(sl), rel=1e-3)
    for a, c in zip(pg, sg):
        rel = float((a.float() - c.float()).norm() / c.float().norm())
        assert rel <= 5e-2
