"""The port's model side against the JAX package: configs, layers,
``Model.loss`` (granite-8b, gemma-7b, starcoder2-7b smoke configs, each
attention ``impl``), ``decode_step``, the samplers and the serve engine.

Weights are the reference's ``init_params`` carried over with
``carry.params_from_jax``; inputs come from numpy with a fixed seed.
Tolerances, with their reasons:

- layers in f32: rel 1e-5 (same formula, other summation order and libm);
  bf16 results: 2^-7 relative (one bf16 rounding flipped either way);
- ``Model.loss``: rel 5e-4.  Every matmul returns bf16 in both packages;
  XLA:CPU and torch sum in another order, so single bf16 roundings of
  activations flip (2^-8 relative each); averaged over the batch's tokens
  the loss moved by at most 1.1e-4 relative in the measured cases;
- forward logits (``lm_hidden`` -> ``lm_logits``; the loss of random
  weights sits near ln(vocab) whatever attention does, the logits are what
  attention determines) and decode logits and caches: 2^-5 of the largest reference entry (eight bf16
  ulps at the top binade: flips of activation roundings accumulate over
  the layers and decode steps; 2^-6 was measured at most);
- greedy tokens: equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the port runs many small ops: intra-op threads of parallel test workers
# only contend for the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.sampler import SamplerConfig, sample  # noqa: E402

DENSE = ["granite-8b", "gemma-7b", "starcoder2-7b"]
IMPLS = ["naive", "blockwise", "pallas"]
LOSS_RTOL = 5e-4
DECODE_REL = 2.0 ** -5


def _models(name, **cfg_kw):
    jcfg = jbase.get_config(name).smoke().scaled(**cfg_kw)
    cfg = base.get_config(name).smoke().scaled(**cfg_kw)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = carry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(cfg), tp


def _close_rel(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * np.abs(want).max())


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_configs_equal_the_reference():
    jall = jbase.all_configs()
    tall = base.all_configs()
    assert sorted(jall) == sorted(tall) and len(tall) == 10
    for name in jall:
        for jc, tc in ((jall[name], tall[name]),
                       (jall[name].smoke(), tall[name].smoke())):
            assert dataclasses.asdict(jc) == dataclasses.asdict(tc), name
            for prop in ("hd", "vocab_padded", "d_inner", "ssm_heads",
                         "has_attention", "has_ssm"):
                assert getattr(jc, prop) == getattr(tc, prop), (name, prop)
            assert jc.n_params() == tc.n_params()
            assert jc.n_active_params() == tc.n_active_params()
            for sname, shape in jbase.SHAPES.items():
                assert dataclasses.asdict(shape) == dataclasses.asdict(
                    base.SHAPES[sname])
                assert jbase.supports(jc, shape) == base.supports(
                    tc, base.SHAPES[sname])


def test_encdec_and_vlm_build_the_reference_tree():
    """The encoder-decoder and VLM families build the reference's
    parameter tree (``test_torch_encdec_vlm.py`` holds their forward,
    decode and training)."""
    for name in ("whisper-tiny", "llava-next-mistral-7b"):
        jc, tc = jbase.get_config(name).smoke(), base.get_config(name).smoke()
        want = {jax.tree_util.keystr(k): tuple(s.shape) for k, s in
                jax.tree_util.tree_flatten_with_path(jtf.param_specs(jc))[0]}
        assert dict(tf.leaves(Model(tc).param_shapes())) == want


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_and_activations_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    x, w, b = _rand((4, 8, 64)), 1 + 0.1 * _rand((64,), 1), _rand((64,), 2)
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (x, w, b))
    tx, tw, tb = (torch.from_numpy(a).to(tdt) for a in (x, w, b))
    for got, want in (
            (layers.rmsnorm(tx, tw), jlayers.rmsnorm(jx, jw)),
            (layers.layernorm(tx, tw, tb), jlayers.layernorm(jx, jw, jb))):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rel,
                                   atol=rel)
    for act, jfn in (("silu", jax.nn.silu), ("gelu", jax.nn.gelu)):
        np.testing.assert_allclose(
            layers.activation(act)(torch.from_numpy(x)).numpy(),
            np.asarray(jfn(jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    x = _rand((2, 12, 4, 16))
    pos = np.arange(3, 15)
    for dt, rel in ((jnp.float32, 1e-5), (jnp.bfloat16, 2.0 ** -7)):
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        want = jlayers.rope(jnp.asarray(x, dt), jnp.asarray(pos), theta)
        got = layers.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                          theta)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=rel,
                                   atol=rel)


@pytest.mark.parametrize("S,chunk", [(32, 8), (30, 8), (16, 512)])
def test_chunked_xent_matches_jax(S, chunk):
    x, e = _rand((2, S, 16)), _rand((40, 16), 1)
    lab = np.random.default_rng(2).integers(0, 40, (2, S)).astype(np.int32)
    want = jlayers.chunked_xent(lambda h, e: jnp.einsum("bsd,vd->bsv", h, e),
                                jnp.asarray(x), jnp.asarray(e),
                                jnp.asarray(lab), chunk=chunk)
    got = layers.chunked_xent(lambda h, e: h @ e.T, torch.from_numpy(x),
                              torch.from_numpy(e), torch.from_numpy(lab),
                              chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# --------------------------------------------------------------------------
# full-sequence forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", DENSE)
def test_loss_matches_jax(name, impl):
    jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    labs = rng.integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    want = float(JModel(jm.cfg, impl=impl, xent_chunk=16).loss(jp, jb))
    got = Model(tm.cfg, impl=impl, xent_chunk=16).loss(tp, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def _jax_logits(jm, jp, toks, impl):
    x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
    x = jtf.backbone(jm.cfg, jp, x, positions=jnp.arange(toks.shape[1]),
                     causal=True, impl=impl)
    h = jlayers.norm(x, jp["ln_f"], jm.cfg.norm)
    e = jp.get("unembed", jp["embed"])
    return np.asarray(jnp.einsum("bsd,vd->bsv", h, e).astype(jnp.float32))


def _port_logits(tm, tp, toks, impl):
    h = tf.lm_hidden(tm.cfg, tp, torch.from_numpy(toks), impl=impl)
    return tf.lm_logits(tm.cfg, tp, h).float().numpy()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", DENSE)
def test_logits_match_jax(name, impl):
    jm, jp, tm, tp = _models(name)
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    V = tm.cfg.vocab
    _close_rel(_port_logits(tm, tp, toks, impl)[..., :V],
               _jax_logits(jm, jp, toks, impl)[..., :V], DECODE_REL)


@pytest.mark.parametrize("fault", ["output zeroed", "keys 8 back dropped"])
def test_logit_check_sees_a_wrong_attention(fault, monkeypatch):
    """The logit comparison above rejects a broken attention."""
    from repro_torch.kernels import ops
    jm, jp, tm, tp = _models("granite-8b")
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    real = ops.flash_attention
    fakes = {"output zeroed": lambda q, k, v, **kw: torch.zeros_like(q),
             "keys 8 back dropped": lambda q, k, v, **kw: real(
                 q, k, v, causal=True, window=8)}
    monkeypatch.setattr(ops, "flash_attention", fakes[fault])
    got = _port_logits(tm, tp, toks, "pallas")
    want = _jax_logits(jm, jp, toks, "pallas")
    assert np.abs(got - want).max() > DECODE_REL * np.abs(want).max()


def test_pallas_impl_reaches_the_flash_wrapper():
    _, _, tm, tp = _models("granite-8b")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    seen = []
    real = flash_attention.flash_attention_bhsd

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return real(*a, **kw)

    flash_attention.flash_attention_bhsd = spy
    try:
        Model(tm.cfg, impl="pallas").loss(tp, {"tokens": toks,
                                               "labels": toks})
    finally:
        flash_attention.flash_attention_bhsd = real
    H, hd = tm.cfg.n_heads, tm.cfg.hd
    assert seen == [torch.Size([H, 16, hd])] * tm.cfg.n_layers


def test_params_carry_keeps_tree_and_bits():
    jm, jp, tm, tp = _models("starcoder2-7b")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = list(tf.leaves(tp))
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    shapes = dict(tf.leaves(tm.param_shapes()))
    assert {p: tuple(b.shape) for p, b in flat_t} == shapes


def test_numpy_params_feed_both_packages_the_same_weights():
    cfg = base.get_config("gemma-7b").smoke()
    npp = carry.numpy_params(cfg, seed=3)
    tp = carry.params_from_jax(npp, device="cpu")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), npp)
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0], tf.leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy(), err_msg=str(p))
    # the reference's distributions: ones for norms, std fan_in^-0.5
    assert np.all(npp["ln_f"]["w"] == 1.0)
    wq = npp["layers"]["attn"]["wq"]
    assert abs(wq.std() * cfg.d_model ** 0.5 - 1.0) < 0.05
    emb = npp["embed"]
    assert abs(emb.std() * cfg.vocab_padded ** 0.5 - 1.0) < 0.05
    assert np.array_equal(carry.numpy_params(cfg, 3)["embed"], emb)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,window", [("granite-8b", 0),
                                         ("granite-8b", 4),
                                         ("starcoder2-7b", 0)])
def test_decode_step_matches_jax(name, window):
    jm, jp, tm, tp = _models(name, sliding_window=window)
    rng = np.random.default_rng(1)
    B, S = 2, 16
    jc = jm.init_decode_state(B, S)
    tc = tm.init_decode_state(B, S, device="cpu")
    for t in [0, 1, 2, 3, 4, 5, 6, 7, 15, 20]:   # 20: the write is clamped
        toks = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        assert tl.dtype == torch.float32
        assert tuple(tl.shape) == (B, tm.cfg.vocab)
        _close_rel(tl.numpy(), jl, DECODE_REL)
        for k in ("k", "v"):
            assert tuple(tc[k].shape) == jc[k].shape
            _close_rel(tc[k].float().numpy(), jc[k], DECODE_REL)


def _tick_log(eng):
    """Wrap a JAX engine's step so that each tick's inputs and logits are
    logged (the logits recomputed by ``Model.decode`` on the same inputs)."""
    log = []
    step = eng._step

    def logged(params, cache, tokens, cache_len, key):
        logits, _ = eng.model.decode(params, cache, tokens, cache_len)
        log.append((np.array(tokens), int(cache_len), np.asarray(logits)))
        return step(params, cache, tokens, cache_len, key)

    eng._step = logged
    return log


def test_greedy_engine_matches_jax_engine():
    """Two slots, three requests of different lengths: the third refills a
    slot mid-run and writes at the other slot's position, as the
    reference's synchronous ``cache_len = pos.max()`` makes it."""
    jm, jp, tm, tp = _models("granite-8b")
    prompts = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2]]
    jeng = jengine.Engine(jm, jp, slots=2, max_seq=32)
    log = _tick_log(jeng)
    teng = Engine(tm, tp, slots=2, max_seq=32)
    jreqs = [jengine.Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run(max_ticks=100)
    teng.run(max_ticks=100)
    assert all(r.done and len(r.out) == 5 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    # teacher-forced: the port's decode on the reference's tick inputs
    cache = tm.init_decode_state(2, 32, device="cpu")
    assert len(log) > 10
    for tokens, cache_len, want in log:
        got, cache = tm.decode(tp, cache, torch.from_numpy(tokens),
                               cache_len)
        _close_rel(got.numpy(), want, DECODE_REL)


# --------------------------------------------------------------------------
# samplers (the cases of tests/test_serve_engine.py) and the engine
# --------------------------------------------------------------------------

def test_sampler_greedy_topk_topp_match_the_reference():
    logits = np.array([[0.0, 5.0, 1.0], [3.0, 0.0, 0.0]], np.float32)
    tl = torch.from_numpy(logits)
    gen = torch.Generator().manual_seed(0)
    for cfg_kw in (dict(temperature=0.0), dict(temperature=1.0, top_k=1),
                   dict(temperature=1.0, top_p=0.01)):
        want = jsampler.sample(jnp.asarray(logits), jax.random.key(1),
                               jsampler.SamplerConfig(**cfg_kw)).tolist()
        got = sample(tl, gen, SamplerConfig(**cfg_kw))
        assert got.dtype == torch.int32
        assert got.tolist() == want == [1, 0]
    # ties: both take the first maximum
    tie = np.array([[2.0, 7.0, 7.0, 1.0]], np.float32)
    assert sample(torch.from_numpy(tie), None, SamplerConfig()).tolist() \
        == np.asarray(jnp.argmax(jnp.asarray(tie), -1)).tolist() == [1]


@pytest.mark.parametrize("cfg_kw", [dict(temperature=1.0),
                                    dict(temperature=0.5, top_k=3),
                                    dict(temperature=1.0, top_p=0.8)])
def test_temperature_sampling_has_the_reference_distribution(cfg_kw):
    """``jax.random.categorical``'s bits cannot be matched: compare the
    frequencies of 20 000 draws from each with the probabilities both
    should have (each within 5 binomial standard deviations)."""
    logits = np.array([[1.0, 2.0, 0.5, -1.0, 1.5]], np.float32)
    n = 20_000
    cfg = SamplerConfig(**cfg_kw)
    gen = torch.Generator().manual_seed(0)
    got = sample(torch.from_numpy(np.repeat(logits, n, 0)), gen, cfg).numpy()
    want = np.asarray(jsampler.sample(jnp.asarray(np.repeat(logits, n, 0)),
                                      jax.random.key(0),
                                      jsampler.SamplerConfig(**cfg_kw)))
    z = logits[0] / cfg.temperature
    keep = np.ones(5, bool)
    if cfg.top_k:
        keep &= z >= np.sort(z)[::-1][cfg.top_k - 1]
    if cfg.top_p < 1.0:
        order = np.argsort(-z)
        p = np.exp(z[order] - z.max())
        cum = np.cumsum(p / p.sum())
        cut = z[order][np.sum(cum < cfg.top_p)]
        keep &= z >= cut
    p = np.where(keep, np.exp(z - z.max()), 0.0)
    p /= p.sum()
    for draws in (got, want):
        freq = np.bincount(draws, minlength=5) / n
        sd = np.sqrt(p * (1 - p) / n)
        assert np.all(np.abs(freq - p) <= 5 * sd + 1e-12), (freq, p)


def test_engine_serves_more_requests_than_slots():
    _, _, tm, tp = _models("granite-8b")
    eng = Engine(tm, tp, slots=2, max_seq=32)
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new=4) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=200)
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 4 for r in reqs)


def test_engine_temperature_sampling_is_seeded():
    _, _, tm, tp = _models("gemma-7b")

    def serve_once(seed):
        eng = Engine(tm, tp, slots=2, max_seq=32, seed=seed,
                     sampler=SamplerConfig(temperature=0.8, top_k=50))
        reqs = [Request(rid=i, prompt=[5, 6, 7], max_new=6)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_ticks=100)
        return [r.out for r in reqs]

    assert serve_once(0) == serve_once(0)
    assert all(0 <= t < tm.cfg.vocab for out in serve_once(1) for t in out)


def test_entry_points_need_a_card_unless_told_cpu():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(base.get_config("granite-8b").smoke()).init(
            torch.Generator(), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    res = serve.main(["--smoke", "--requests", "3", "--slots", "2",
                      "--max-new", "3", "--device", "cpu"])
    assert res["tokens"] == 9
