"""The port's Mamba2 layer (``models/ssm.py``) and the SSD kernel's route
against the JAX package.

Inputs come from numpy with a fixed seed and go to both packages.
Tolerances, with their reasons:

- ``ssd_chunked`` in f32: its intra-chunk block (``y_diag`` and the chunk
  states before their bf16 rounding) against the reference's einsums at
  rel/abs 2e-6 (same formula and, through ``ref.xla_cumsum``, the same
  prefix sums; other einsum summation order, other ``exp``: measured
  2.2e-7); the whole output at 2e-6 as well: both packages round the
  chunk states to bf16, and with the prefix sums added in the reference's
  order no rounding flips here (measured 2.4e-7; 6e-5 with
  ``torch.cumsum``'s prefix sums, under which state roundings flipped);
- ``ssd_chunked`` with bf16 x, B, C: 2^-7 of the largest entry (one bf16
  rounding of ``scores`` flipped either way);
- the ``impl="pallas"`` form (the intra-chunk block from
  ``ssd_scan.ssd_intra_chunk``, whose CPU version is the plain one) in
  f32 against JAX's ``ssd_chunked`` and its kernel-backed ``ops.ssd``
  (interpret mode): 2e-6 (measured 2.4e-7; 6e-5 with ``torch.cumsum``);
- ``ssm_forward`` prefill against JAX (f32 weights and inputs): rel/abs
  2e-5 of the largest entry; decode step by step against prefill and the
  final state against ``ssm_reference``: 2e-3, the bound of
  ``tests/test_archs_smoke.py``.

``tests/test_torch_ssm_stages.py`` holds the layer stage by stage at the
widths of hymba-1.5b and mamba2-1.3b.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# intra-op threads of parallel test workers only contend for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import xla_cumsum  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

bf16, f32 = torch.bfloat16, torch.float32


def _inputs(b, l, h, p, n, seed=3):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, l, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, l, n))).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * np.abs(want).max())


SHAPES = [((2, 32, 4, 16, 16), 8), ((1, 64, 2, 16, 32), 16),
          ((2, 48, 3, 8, 16), 16)]


def _jax_intra(x, dt, A, B, C, chunk):
    """``y_diag`` and the unrounded chunk states, as the reference's
    ``ssd_chunked`` computes them (``repro/models/ssm.py``)."""
    b, l, h, p = x.shape
    c, n = l // chunk, B.shape[-1]
    xb, dtb = x.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h)
    Bb, Cb = B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n)
    a = dtb * A[None, None, None, :]
    a_cum = jnp.cumsum(a, axis=2)
    Lmat = jnp.exp(jssm._segsum(a.transpose(0, 1, 3, 2)))
    scores = jnp.einsum("bcqn,bckn->bcqk", Cb, Bb)
    y_diag = jnp.einsum("bchqk,bcqk,bckh,bckhp->bcqhp", Lmat, scores, dtb,
                        xb)
    decay_to_end = jnp.exp(a_cum[:, :, -1:, :] - a_cum)
    states = jnp.einsum("bcqn,bcqh,bcqh,bcqhp->bchpn", Bb, dtb,
                        decay_to_end, xb)
    return y_diag, states


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("shape,chunk", SHAPES)
def test_ssd_chunked_matches_jax_f32(shape, chunk, impl):
    arrs = _inputs(*shape)
    ja = [jnp.asarray(a) for a in arrs]
    ta = [torch.from_numpy(a) for a in arrs]
    y_j, st_j = jssm.ssd_chunked(*ja, chunk)
    y_t, st_t = ssm.ssd_chunked(*ta, chunk, impl=impl)
    assert y_t.dtype == f32 and st_t.dtype == f32
    assert tuple(y_t.shape) == y_j.shape and tuple(st_t.shape) == st_j.shape
    for got, want in ((y_t, y_j), (st_t, st_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)
    # the intra-chunk block itself, before the states' bf16 rounding
    b, l, h, p = arrs[0].shape
    c, n = l // chunk, arrs[3].shape[-1]
    xb, dtb = ta[0].reshape(b, c, chunk, h, p), ta[1].reshape(b, c, chunk, h)
    y_d, st_d, _ = ssm._intra_reference(
        xb, dtb, ta[2], ta[3].reshape(b, c, chunk, n),
        ta[4].reshape(b, c, chunk, n), xla_cumsum(dtb * ta[2], 2))
    for got, want in zip((y_d, st_d), _jax_intra(*ja, chunk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("shape,chunk", SHAPES[:2])
def test_ssd_chunked_matches_jax_bf16(shape, chunk, impl):
    x, dt, A, B, C = _inputs(*shape)
    jin = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
           jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16))
    tin = (torch.from_numpy(x).to(bf16), torch.from_numpy(dt),
           torch.from_numpy(A), torch.from_numpy(B).to(bf16),
           torch.from_numpy(C).to(bf16))
    y_j, st_j = jssm.ssd_chunked(*jin, chunk)
    y_t, st_t = ssm.ssd_chunked(*tin, chunk, impl=impl)
    assert y_t.dtype == f32 and y_j.dtype == jnp.float32
    _close(y_t.numpy(), y_j, 2.0 ** -7)
    _close(st_t.numpy(), st_j, 2.0 ** -7)


@pytest.mark.parametrize("shape,chunk", SHAPES)
def test_pallas_form_matches_jax_ssd_and_kernel(shape, chunk):
    arrs = _inputs(*shape)
    ja = [jnp.asarray(a) for a in arrs]
    before = (ssd_scan.launches, ssd_scan.tc_launches)
    y_t, st_t = ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk,
                                impl="pallas")
    assert (ssd_scan.launches, ssd_scan.tc_launches) == before  # CPU
    for y_w, st_w in (jssm.ssd_chunked(*ja, chunk),
                      jops.ssd(*ja, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_w), rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_allclose(st_t.numpy(), np.asarray(st_w),
                                   rtol=2e-6, atol=2e-6)


def test_round_scores_mirrors_the_reference_scores():
    """With bf16 B and C the model path asks the intra-chunk block to round
    C B^T to bf16 (``round_scores``), as the reference's ``scores`` einsum
    does: its y_diag and states then equal the reference formulation's up
    to f32 sums (1e-4 of each output's largest entry; measured 0 here),
    and keeping the scores in f32 moves y_diag by more (1.7e-3)."""
    x, dt, A, B, C = _inputs(2, 64, 4, 16, 32)
    b, l, h, p = x.shape
    c, q, n = 4, 16, 32
    tx = torch.from_numpy(x).to(bf16).reshape(b, c, q, h, p)
    tdt = torch.from_numpy(dt).reshape(b, c, q, h)
    tA = torch.from_numpy(A)
    tB, tC = (torch.from_numpy(a).to(bf16).reshape(b, c, q, n)
              for a in (B, C))
    y_r, st_r, dc_r = ssm._intra_reference(tx, tdt, tA, tB, tC,
                                           xla_cumsum(tdt * tA, 2))
    y_k, st_k, dc_k = ssm._intra_kernel(tx, tdt, tA, tB, tC)
    for got, want in ((y_k, y_r), (st_k, st_r), (dc_k, dc_r)):
        _close(got.numpy(), want.numpy(), 1e-4)
    xk = tx.permute(0, 3, 1, 2, 4).reshape(b * h, c, q, p)
    dtk = tdt.permute(0, 3, 1, 2).reshape(b * h, c, q)
    y_f = ssd_scan.ssd_intra_chunk(xk, dtk, tA.repeat(b), tB, tC, heads=h)[0]
    y_f = y_f.reshape(b, h, c, q, p).permute(0, 2, 3, 1, 4)
    assert np.abs(y_f.numpy() - y_r.numpy()).max() \
        > 1e-4 * np.abs(y_r.numpy()).max()


@pytest.mark.parametrize("dtype", [f32, bf16])
def test_intra_chunk_heads_equals_expanded_call(dtype):
    """B and C by group index (``heads=``) give the bits of the call on B
    and C expanded per head."""
    rng = np.random.default_rng(5)
    G, heads, c, Q, P, N = 2, 3, 2, 16, 8, 16
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x = mk(G * heads, c, Q, P).to(dtype)
    dt = torch.nn.functional.softplus(mk(G * heads, c, Q))
    A = -torch.exp(0.3 * mk(G * heads))
    B, C = mk(G, c, Q, N).to(dtype), mk(G, c, Q, N).to(dtype)
    for rs in (False, True):
        got = ssd_scan.ssd_intra_chunk(x, dt, A, B, C, heads=heads,
                                       round_scores=rs)
        want = ssd_scan.ssd_intra_chunk(
            x, dt, A, B.repeat_interleave(heads, 0),
            C.repeat_interleave(heads, 0), round_scores=rs)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError, match="multiple of heads"):
        ssd_scan.ssd_intra_chunk(x, dt, A, B, C, heads=4)
    with pytest.raises(ValueError, match="shapes"):
        ssd_scan.ssd_intra_chunk(x, dt, A, B, C, heads=2)


ROUTES = [
    # (x, dt, A, B, C dtypes), Q, P, N, route
    ((bf16, f32, f32, bf16, bf16), 128, 64, 128, "tensor_core"),  # mamba2
    ((bf16, f32, f32, bf16, bf16), 64, 64, 64, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 128, 256, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 256, 64, 128, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 64, 16, 16, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 50, 16, "tensor_core"),   # hymba P
    ((bf16, f32, f32, bf16, bf16), 64, 24, 16, "tensor_core"),    # x by
    ((bf16, f32, f32, bf16, bf16), 128, 40, 32, "tensor_core"),   # threads
    ((bf16, f32, f32, bf16, bf16), 128, 100, 32, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 256, 130, 16, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 250, 16, "tensor_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 49, 16, "cuda_core"),     # odd P
    ((bf16, f32, f32, bf16, bf16), 128, 51, 16, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 258, 16, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 8, 16, 16, "cuda_core"),       # smoke Q
    ((bf16, f32, f32, bf16, bf16), 16, 16, 16, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 96, 64, 128, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 512, 64, 128, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 272, 128, "cuda_core"),
    ((bf16, f32, f32, bf16, bf16), 128, 64, 24, "cuda_core"),
    ((f32, f32, f32, f32, f32), 128, 64, 128, "cuda_core"),       # f32
    ((bf16, bf16, f32, bf16, bf16), 128, 64, 128, "cuda_core"),   # bf16 dt
    ((bf16, f32, f32, f32, f32), 128, 64, 128, "cuda_core"),
]


@pytest.mark.parametrize("case", ROUTES)
def test_route(case):
    dtypes, Q, P, N, want = case
    assert ssd_scan.route(dtypes, Q, P, N) == want


def _layer_params(cfg, seed=0, std=0.05):
    """f32 weights for one SSM layer (A = -1, dt_bias 0, as the reference's
    smoke test sets them)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in ssm.ssm_shapes(cfg).items():
        out[k] = (std * rng.standard_normal(shape)).astype(np.float32)
    out["a_log"][:] = 0.0
    out["dt_bias"][:] = 0.0
    return out


def test_ssm_forward_prefill_decode_and_oracle_match_jax():
    cfg = get_config("mamba2-1.3b").smoke()
    npp = _layer_params(cfg)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = {k: torch.from_numpy(v) for k, v in npp.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)

    y_j, st_j = jssm.ssm_forward(jx, jp, jget("mamba2-1.3b").smoke())
    for impl in ("naive", "pallas"):
        y_t, st_t = ssm.ssm_forward(tx, tp, cfg, impl=impl)
        _close(y_t.numpy(), y_j, 2e-5 if impl == "naive" else 2e-4)
        _close(st_t["ssm"].numpy(), st_j["ssm"],
               2e-5 if impl == "naive" else 2e-4)

    y_r, st_r = ssm.ssm_reference(tx, tp, cfg)
    y_rj, st_rj = jssm.ssm_reference(jx, jp, jget("mamba2-1.3b").smoke())
    _close(y_r.numpy(), y_rj, 2e-5)
    y_c, st_c = ssm.ssm_forward(tx, tp, cfg)
    np.testing.assert_allclose(st_c["ssm"].numpy(), st_r["ssm"].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(y_c.numpy(), y_r.numpy(), rtol=2e-3,
                               atol=2e-3)

    # recurrent one-step decode reproduces the sequence
    state = {"ssm": torch.zeros_like(st_r["ssm"])}
    ys = []
    for t in range(16):
        y_t, state = ssm.ssm_forward(tx[:, t:t + 1], tp, cfg, state=state)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_r.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state["ssm"].numpy(), st_r["ssm"].numpy(),
                               rtol=2e-3, atol=2e-3)
    # and one decode step equals JAX's
    s0 = np.random.default_rng(2).standard_normal(
        st_r["ssm"].shape).astype(np.float32)
    yd_j, sd_j = jssm.ssm_forward(jx[:, :1], jp, jget("mamba2-1.3b").smoke(),
                                  state={"ssm": jnp.asarray(s0)})
    yd_t, sd_t = ssm.ssm_forward(tx[:, :1], tp, cfg,
                                 state={"ssm": torch.from_numpy(s0)})
    _close(yd_t.numpy(), yd_j, 2e-5)
    _close(sd_t["ssm"].numpy(), sd_j["ssm"], 2e-5)


def test_param_tree_and_init_rules_match_the_reference():
    cfg = get_config("mamba2-1.3b").smoke()
    specs = jtf.param_specs(jget("mamba2-1.3b").smoke())
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    want = {jax.tree_util.keystr(p): (s.shape, s.dtype) for p, s in flat}
    got = dict(tf.leaves(tf.param_shapes(cfg)))
    assert list(got) == list(want)
    assert {k: v[0] for k, v in want.items()} == got
    for name in got:
        assert tf.is_f32_leaf(name) == (want[name][1] == jnp.float32), name
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for name, t in tf.leaves(tp):
        assert t.dtype == (f32 if tf.is_f32_leaf(name) else bf16), name
    s = tp["layers"]["ssm"]
    assert torch.all((s["a_log"] >= 0) & (s["a_log"] <= np.log(16.0)))
    assert torch.all(s["dt_bias"] == 0) and torch.all(s["d_skip"] == 1)
    assert torch.all(s["norm_w"] == 1) and s["norm_w"].dtype == bf16


def test_carry_keeps_the_f32_leaves():
    cfg = get_config("mamba2-1.3b").smoke()
    jp = jtf.init_params(jget("mamba2-1.3b").smoke(), jax.random.key(0))
    npj = jax.tree.map(np.asarray, jp)
    tp = carry.params_from_jax(npj, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(npj)[0]
    for (p, a), (name, b) in zip(flat_j, tf.leaves(tp)):
        assert jax.tree_util.keystr(p) == name
        if a.dtype == np.float32:
            assert tf.is_f32_leaf(name) and b.dtype == f32, name
            np.testing.assert_array_equal(b.numpy(), a)    # bitwise
        else:
            assert b.dtype == bf16, name
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.astype(np.float32))
    # numpy_params: a_log drawn as log U(1, 16), kept f32 and unrounded
    npp = carry.numpy_params(cfg, seed=1)
    a_log = npp["layers"]["ssm"]["a_log"]
    assert a_log.dtype == np.float32
    assert np.all((a_log >= 0) & (a_log <= np.log(16.0)))
    assert not np.array_equal(a_log, carry.round_bf16(a_log.copy()))
    tp = carry.params_from_jax(npp, device="cpu")
    assert tp["layers"]["ssm"]["a_log"].dtype == f32
    np.testing.assert_array_equal(tp["layers"]["ssm"]["a_log"].numpy(),
                                  a_log)
    assert np.all(npp["layers"]["ssm"]["dt_bias"] == 0)
    assert np.all(npp["layers"]["ssm"]["d_skip"] == 1)
    assert tp["layers"]["ssm"]["w_xz"].dtype == bf16
