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
  scatter writes drop on the card as on the CPU (no device-side assert).
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
