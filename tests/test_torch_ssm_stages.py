"""The port's Mamba2 layer against ``repro/models/ssm.py``, stage by stage,
at the SSM widths of hymba-1.5b (d 1600, H 64, P 50, N 16) and mamba2-1.3b
(d 2048, H 64, P 64, N 128): one layer, chunk 128, S 256 (two chunks), f32
weights drawn as ``carry.numpy_params`` draws them (``a_log`` = log
U(1, 16), ``dt_bias`` 0), with bf16 and f32 layer inputs.  Each stage is
fed the reference's own inputs, made from a numpy seed, so that a
difference shows where it arises.  At these decay rates the within-chunk
prefix sums of ``a = dt A`` reach ~1e3, where a last-place difference of
a sum is ~1e-5 of its decay; the shapes of ``tests/test_torch_ssm.py``
(|a_cum| near 16) cannot show that.

Bounds, with their reasons ("of the largest": of the largest entry of
the reference's output; "measured": over the four cases here):

- ``xla_cumsum`` against ``jnp.cumsum``, on lengths 8 to 512, |a| up to
  50, in the 1-D layout of the kernel's ``acum`` and the 3-D
  ``[b, c, q, h]`` one of ``ssd_chunked``: bitwise, since it adds in the
  order XLA:CPU compiles ``cumsum`` into; its gradient, ``torch.cumsum``'s
  reversed scan, within 1e-6 of the largest entry of JAX's (another
  order of the same f32 sums; measured 2.5e-7);
- ``a_cum`` and ``_segsum``'s prefix differences: bitwise (the same sums
  of the same inputs);
- ``decay_to_end`` and ``Lmat``: rel 1e-6 wherever the reference's value
  is at least 1e-30 (measured 1.2e-7).  ``torch.exp`` and XLA's ``exp``
  differ in the last place on ~10% of f32 inputs, and part further in the
  denormal range, where both only have to stay below 1e-29;
- ``y_diag`` and the chunk states before their bf16 rounding, from
  ``impl="naive"``'s block and from ``"pallas"``'s (the kernel's plain
  version on the CPU): 1e-6 of the largest (the same formula with other
  f32 sum orders and the last-place ``exp``; measured 1.1e-7; 6e-6 to
  1.5e-5 with ``torch.cumsum``'s prefix sums);
- the bf16 chunk states: equal but for one-ulp flips in at most 0.05% of
  the entries, the roundings that those last-place f32 differences cross
  (measured 0.002%; 0.12-0.25% with ``torch.cumsum``, some by hundreds
  of steps);
- ``ssd_chunked``'s ``y`` and final state, for both ``impl``: 1e-6 of
  the largest beyond what the flipped bf16 chunk states carry into each
  entry (|the flip| into the final state; |C| times it into the next
  chunk's ``y``).  One flip of a large state moves the final state by up
  to 2^-8 of that state (measured 1.8e-4 of the largest for ``"pallas"``
  at mamba2's width); beyond the flips' share the rest measured 8.1e-8
  (1.1e-5 to 1.5e-5 with ``torch.cumsum``);
- the gated norm (D skip, the gate, the RMSNorm before its weight), given
  the reference's ``y``: in f32, 1e-6 of the largest (``silu``,
  ``rsqrt`` and the mean's sum order differ in the last place; measured
  1e-7); in bf16, equal but for flips of at most two steps in at most
  0.05% of the entries (measured 0.0002%): the gate's bf16 product flips
  by one step of its own binade, which the normalization can carry into
  a lower one, where it is two;
- the epilogue's output (the gated norm, its weight, the output
  projection), given the reference's ``y``: 2e-6 of the largest beyond
  what the gated norm's flipped bf16 entries carry through ``w_out``
  (f32 sums over 3200 or 4096 terms; measured 8.1e-7);
- the input projections: 4e-6 of the largest (f32 matmuls over d 1600 or
  2048 terms, whose order the port cannot match; measured 8.2e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.ref import xla_cumsum  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

S = 256                   # two chunks of 128
CASES = [(arch, dtype) for arch in ("hymba-1.5b", "mamba2-1.3b")
         for dtype in ("bfloat16", "float32")]
IMPLS = ("naive", "pallas")
STAGE_ATOL = 1e-6         # of the largest reference entry
EXP_RTOL, EXP_FLOOR = 1e-6, 1e-30
MAX_FLIPS = 5e-4          # share of a bf16 stage's entries
EPILOGUE_ATOL = 2e-6
PROJECT_ATOL = 4e-6


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def rel(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def ulps(got, want) -> np.ndarray:
    """|got - want| in steps of the bf16 grid, entry by entry."""
    def line(bits):                  # bf16 bit patterns, in value order
        bits = bits.astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(line(got.view(torch.int16).numpy())
                  - line(np.asarray(want).view(np.int16)))


def _jax_project(x, p, cfg):
    """The reference's projections, as ``jssm.ssm_forward`` writes them."""
    Bsz, S_, _ = x.shape
    xin, z = jnp.split(jnp.einsum("bsd,de->bse", x, p["w_xz"]), 2, axis=-1)
    Bm, Cm = jnp.split(jnp.einsum("bsd,de->bse", x, p["w_bc"]), 2, axis=-1)
    dt = jax.nn.softplus(
        jnp.einsum("bsd,dh->bsh", x, p["w_dt"]).astype(jnp.float32)
        + p["dt_bias"])
    A = -jnp.exp(p["a_log"])
    return (xin.reshape(Bsz, S_, cfg.ssm_heads, cfg.ssm_head_dim), z, Bm,
            Cm, dt, A)


def _jax_intra(xh, z, Bm, Cm, dt, A, chunk):
    """The stages of the reference's ``ssd_chunked`` up to the chunk
    states' bf16 rounding."""
    b, l, h, p = xh.shape
    c, n = l // chunk, Bm.shape[-1]
    xb, dtb = xh.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h)
    Bb, Cb = Bm.reshape(b, c, chunk, n), Cm.reshape(b, c, chunk, n)
    a = dtb * A[None, None, None, :]
    a_cum = jnp.cumsum(a, axis=2)
    seg = jssm._segsum(a.transpose(0, 1, 3, 2))
    Lmat = jnp.exp(seg)
    scores = jnp.einsum("bcqn,bckn->bcqk", Cb, Bb)
    y_diag = jnp.einsum("bchqk,bcqk,bckh,bckhp->bcqhp", Lmat, scores, dtb,
                        xb)
    decay_to_end = jnp.exp(a_cum[:, :, -1:, :] - a_cum)
    states = jnp.einsum("bcqn,bcqh,bcqh,bcqhp->bchpn", Bb, dtb,
                        decay_to_end, xb)
    return dict(a=a, a_cum=a_cum, seg=seg, Lmat=Lmat, y_diag=y_diag,
                decay_to_end=decay_to_end, states=states)


def _jax_gated_norm(y, xh, z, x, p):
    """The reference's epilogue up to the RMSNorm's weight."""
    Bsz, S_, H, P = xh.shape
    y = y + xh.astype(jnp.float32) * p["d_skip"][None, None, :, None]
    y = y.reshape(Bsz, S_, H * P).astype(x.dtype)
    y = y * jax.nn.silu(z.astype(jnp.float32)).astype(x.dtype)
    yf = y.astype(jnp.float32)
    ms = jnp.mean(yf * yf, axis=-1, keepdims=True)
    return (yf * jax.lax.rsqrt(ms + 1e-6)).astype(x.dtype)


def stages(arch: str, dtype: str, seed: int = 0) -> dict:
    """Each stage's (port, reference) pair, the port fed the reference's
    inputs to the stage, and the allowances of the bf16 flips."""
    cfg = get_config(arch).scaled(n_layers=1, vocab=256)
    chunk = cfg.ssm_chunk
    tree = carry.numpy_params(cfg, seed, rounded=False)["layers"]["ssm"]
    npp = {k: np.ascontiguousarray(v[0]) for k, v in tree.items()}
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = {k: torch.from_numpy(v) for k, v in npp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    out = {}
    jproj = _jax_project(jx, jp, cfg)
    for name, got, want in zip(("xh", "z", "B", "C", "dt", "A"),
                               ssm._project(tx, tp, cfg), jproj):
        out["project." + name] = (got, want)
    xh, z, Bm, Cm, dt, A = (torch.from_numpy(np.array(a)) for a in jproj)

    ref = _jax_intra(*jproj, chunk)
    b, l, h, p = xh.shape
    c, n = l // chunk, Bm.shape[-1]
    xb, dtb = xh.reshape(b, c, chunk, h, p), dt.reshape(b, c, chunk, h)
    Bb, Cb = Bm.reshape(b, c, chunk, n), Cm.reshape(b, c, chunk, n)
    a = torch.from_numpy(np.array(ref["a"]))
    a_cum = xla_cumsum(a, 2)
    seg = ssm._segsum(a_cum.permute(0, 1, 3, 2))
    out["a_cum"] = (a_cum, ref["a_cum"])
    out["seg"] = (seg, ref["seg"])
    out["Lmat"] = (torch.exp(seg), ref["Lmat"])
    out["decay_to_end"] = (torch.exp(a_cum[:, :, -1:] - a_cum),
                           ref["decay_to_end"])

    y_j, final_j = jssm.ssd_chunked(jproj[0], jproj[4], jproj[5], jproj[2],
                                    jproj[3], chunk)
    states_j = ref["states"].astype(jnp.bfloat16)
    for impl in IMPLS:
        y_d, st_d, _ = (ssm._intra_reference(xb, dtb, A, Bb, Cb, a_cum)
                        if impl == "naive" else
                        ssm._intra_kernel(xb, dtb, A, Bb, Cb))
        out[f"{impl}.y_diag"] = (y_d, ref["y_diag"])
        out[f"{impl}.states"] = (st_d, ref["states"])
        st_t = st_d.to(torch.bfloat16)
        steps = ulps(st_t, states_j)
        out[f"{impl}.states_ulps"] = steps
        # what the flipped states carry: into the final state |ds|, into
        # the next chunk's y |C| |ds| (decays <= 1; with two chunks the
        # carried-in state is the first chunk's, exact in bf16)
        ds = np.where(steps > 0, np.abs(_np(st_t) - _np(states_j)), 0.0)
        carried = np.cumsum(ds, axis=1) - ds               # [b,c,h,p,n]
        y_t, final_t = ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk, impl=impl)
        out[f"{impl}.y"] = (y_t, y_j, np.einsum(
            "bcqn,bchpn->bcqhp", np.abs(Cb.numpy()), carried).reshape(
                y_t.shape))
        out[f"{impl}.final"] = (final_t, final_j, ds.sum(axis=1))

    yn_j = _jax_gated_norm(y_j, *jproj[:2], jx, jp)
    yn_t = ssm._gated_norm(torch.from_numpy(np.array(y_j)), xh, z, tx, tp)
    out["gated_norm"] = (yn_t, yn_j)
    allow = np.zeros(yn_t.shape, np.float32)
    if yn_t.dtype == torch.bfloat16:
        out["gated_norm_ulps"] = steps = ulps(yn_t, yn_j)
        allow = np.where(steps > 0, np.abs(_np(yn_t) - _np(yn_j)), 0.0) \
            * np.abs(npp["norm_w"])
    out["epilogue"] = (
        ssm._epilogue(torch.from_numpy(np.array(y_j)), xh, z, tx, tp),
        jnp.einsum("bse,ed->bsd", yn_j * jp["norm_w"], jp["w_out"]),
        allow @ np.abs(npp["w_out"]))
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-{d}" for a, d in CASES])
def st(request):
    return stages(*request.param)


def _within(got, want, allowance, atol):
    """|got - want| <= atol * max|want| + allowance, entry by entry."""
    got, want = _np(got), _np(want)
    excess = np.abs(got - want) - allowance - atol * np.abs(want).max()
    assert excess.max() <= 0, (rel(got, want), excess.max())


@pytest.mark.parametrize("layout", ["1d", "3d"])
@pytest.mark.parametrize("L", [8, 16, 24, 100, 128, 256, 512])
def test_xla_cumsum_is_jnp_cumsum_bitwise(L, layout):
    """The sums bit for bit; their gradient is ``torch.cumsum``'s (the
    reversed scan), within 1e-6 of the reference's largest entry."""
    rng = np.random.default_rng(L)
    shape, dim = ((L,), 0) if layout == "1d" else ((2, 3, L, 4), 2)
    a = (-50.0 * rng.random(shape)).astype(np.float32)
    g = (10.0 * rng.standard_normal(shape)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jnp.cumsum(t, axis=dim), jnp.asarray(a))
    ta, tg = torch.from_numpy(a).requires_grad_(True), torch.from_numpy(g)
    got = xla_cumsum(ta, dim)
    got.backward(tg)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(ta.grad.numpy(),
                                  tg.flip(dim).cumsum(dim).flip(dim).numpy())
    assert rel(ta.grad, vjp(jnp.asarray(g))[0]) <= STAGE_ATOL


def test_prefix_sums_are_the_references_bitwise(st):
    for name in ("a_cum", "seg"):
        got, want = st[name]
        np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


def test_decays_within_an_ulp_of_exp(st):
    for name in ("decay_to_end", "Lmat"):
        got, want = (_np(t) for t in st[name])
        big = want >= EXP_FLOOR
        np.testing.assert_allclose(got[big], want[big], rtol=EXP_RTOL,
                                   atol=0, err_msg=name)
        assert np.all(got[~big] < 10 * EXP_FLOOR), name


@pytest.mark.parametrize("impl", IMPLS)
def test_intra_chunk_block(st, impl):
    for name in ("y_diag", "states"):
        got, want = st[f"{impl}.{name}"]
        assert rel(got, want) <= STAGE_ATOL, (name, rel(got, want))
    steps = st[f"{impl}.states_ulps"]
    assert steps.max() <= 1 and (steps > 0).mean() <= MAX_FLIPS, \
        (steps.max(), (steps > 0).mean())


@pytest.mark.parametrize("impl", IMPLS)
def test_ssd_chunked_output_and_final_state(st, impl):
    for name in ("y", "final"):
        _within(*st[f"{impl}.{name}"], STAGE_ATOL)


def test_gated_norm(st):
    got, want = st["gated_norm"]
    if got.dtype == torch.bfloat16:
        steps = st["gated_norm_ulps"]
        assert steps.max() <= 2 and (steps > 0).mean() <= MAX_FLIPS, \
            (steps.max(), (steps > 0).mean())
    else:
        assert rel(got, want) <= STAGE_ATOL, rel(got, want)


def test_epilogue(st):
    _within(*st["epilogue"], EPILOGUE_ATOL)


def test_projections(st):
    for name in ("xh", "z", "B", "C", "dt", "A"):
        got, want = st["project." + name]
        assert rel(got, want) <= PROJECT_ATOL, (name, rel(got, want))
