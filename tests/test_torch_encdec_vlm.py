"""The port's encoder-decoder (whisper-tiny) and VLM
(llava-next-mistral-7b) families, and every registered arch, against the
JAX package: parameter trees, ``input_specs``/``make_inputs``,
``Model.loss`` per ``impl``, the forward's logits, decode, the greedy
engine, the cross-attention, and one training step of each family.

Weights are the reference's ``init_params`` carried over with
``carry.params_from_jax``; inputs (tokens, frame and patch embeddings)
come from numpy with a fixed seed.  Tolerances, with their reasons (as
``test_torch_model.py``'s):

- ``Model.loss``: rel 5e-4 (flipped bf16 roundings of activations,
  averaged over the batch's tokens);
- forward and decode logits: 2^-5 of the largest reference entry (eight
  bf16 ulps at the top binade);
- greedy tokens: equal;
- a training step: ``torch_compare.assert_train_pair_close``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_model import _close_rel, _tick_log  # noqa: E402
from torch_compare import (assert_train_pair_close,  # noqa: E402
                           train_inputs, train_step_pair)

NAMES = ["whisper-tiny", "llava-next-mistral-7b"]
ALL = sorted(base.all_configs())
IMPLS = ["naive", "blockwise", "pallas"]
LOSS_RTOL = 5e-4
REL = 2.0 ** -5
S = 24


def _models(name):
    jcfg = jbase.get_config(name).smoke()
    cfg = base.get_config(name).smoke()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = carry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module", params=NAMES)
def models(request):
    return _models(request.param)


def _batches(cfg, B=2, seed=0):
    b = train_inputs(cfg, B, S, seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# --------------------------------------------------------------------------
# parameters and inputs, every arch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_param_shapes_match_reference(name):
    for jc, tc in ((jbase.get_config(name), base.get_config(name)),
                   (jbase.get_config(name).smoke(),
                    base.get_config(name).smoke())):
        specs = jtf.param_specs(jc)
        want = {jax.tree_util.keystr(k): tuple(s.shape) for k, s in
                jax.tree_util.tree_flatten_with_path(specs)[0]}
        got = dict(tf.leaves(tf.param_shapes(tc)))
        assert list(got) == list(want) and got == want, name


def _shapes():
    return [base.SHAPES[k] for k in ("train_4k", "prefill_32k",
                                     "decode_32k")] \
        + [base.ShapeSpec("small", 600, 3, "train")]


@pytest.mark.parametrize("name", ALL)
def test_input_specs_and_make_inputs_match_reference(name):
    jm, tm = JModel(jbase.get_config(name)), Model(base.get_config(name))
    dt = {jnp.int32: torch.int32, jnp.float32: torch.float32}
    for shape in _shapes():
        jshape = jbase.ShapeSpec(**dataclasses.asdict(shape))
        want = {k: (tuple(s.shape), dt[s.dtype.type])
                for k, s in jm.input_specs(jshape).items()}
        assert tm.input_specs(shape) == want, (name, shape.name)
    sm = Model(base.get_config(name).smoke())
    small = base.ShapeSpec("t", 20, 2, "train")
    got = sm.make_inputs(small, torch.Generator().manual_seed(0))
    spec = sm.input_specs(small)
    assert sorted(got) == sorted(spec)
    for k, (s, dtype) in spec.items():
        assert tuple(got[k].shape) == s and got[k].dtype == dtype, k
    assert 0 <= int(got["tokens"].min()) and \
        int(got["tokens"].max()) < sm.cfg.vocab
    again = sm.make_inputs(small, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)
    dec = sm.make_inputs(base.ShapeSpec("d", 20, 2, "decode"),
                         torch.Generator().manual_seed(0))
    assert tuple(dec["tokens"].shape) == (2, 1) and int(dec["cache_len"]) \
        == 0


@pytest.mark.parametrize("name", ALL)
def test_every_arch_builds_computes_the_loss_and_decodes(name):
    """``Model(cfg)`` of every registered arch (smoke config): the loss of
    one batch and two decode steps against the reference's."""
    jm, jp, tm, tp = _models(name)
    jb, tb = _batches(tm.cfg)
    with jax.disable_jit():
        want = float(JModel(jm.cfg, xent_chunk=8).loss(jp, jb))
    got = float(Model(tm.cfg, xent_chunk=8).loss(tp, tb))
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    jc, tc = jm.init_decode_state(2, 8), tm.init_decode_state(2, 8, "cpu")
    for t in (0, 1):
        toks = np.array([[3 + t], [7]], np.int32)
        with jax.disable_jit():
            jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        _close_rel(tl.numpy(), jl, REL)


# --------------------------------------------------------------------------
# whisper and llava: loss, logits, decode, engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_loss_matches_reference(models, impl):
    jm, jp, tm, tp = models
    jb, tb = _batches(tm.cfg)
    want = float(JModel(jm.cfg, impl=impl, xent_chunk=8).loss(jp, jb))
    got = Model(tm.cfg, impl=impl, xent_chunk=8).loss(tp, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def _jax_logits(jm, jp, jb, impl):
    cfg = jm.cfg
    x = jp["embed"][jb["tokens"]].astype(jnp.bfloat16)
    enc = None
    if cfg.family == "vlm":
        px = jnp.einsum("bpd,de->bpe", jb["patches"].astype(jnp.bfloat16),
                        jp["patch_proj"])
        x = jnp.concatenate([px, x], axis=1)
    if cfg.family == "encdec":
        enc = jtf.encoder(cfg, jp, jb["frames"].astype(jnp.bfloat16),
                          impl=impl)
    x = jtf.backbone(cfg, jp, x, positions=jnp.arange(x.shape[1]),
                     causal=True, impl=impl, enc_out=enc)
    x = jtf.norm(x, jp["ln_f"], cfg.norm)[:, -jb["tokens"].shape[1]:]
    e = jp.get("unembed", jp["embed"])
    return np.asarray(jnp.einsum("bsd,vd->bsv", x, e).astype(jnp.float32))


def _port_logits(tm, tp, tb, impl):
    h = tf.lm_hidden(tm.cfg, tp, tb["tokens"], impl=impl,
                     frames=tb.get("frames"), patches=tb.get("patches"))
    return tf.lm_logits(tm.cfg, tp, h).float().numpy()


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_match_reference(models, impl):
    jm, jp, tm, tp = models
    jb, tb = _batches(tm.cfg, seed=1)
    V = tm.cfg.vocab
    got = _port_logits(tm, tp, tb, impl)
    assert got.shape[1] == S                   # the text positions only
    _close_rel(got[..., :V], _jax_logits(jm, jp, jb, impl)[..., :V], REL)


def test_decode_matches_reference(models):
    """The decoder alone, as the reference's ``decode_step`` runs it (no
    encoder, no patches): logits and caches over 10 steps."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    jc, tc = jm.init_decode_state(2, 16), tm.init_decode_state(2, 16, "cpu")
    for t in range(10):
        toks = rng.integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        _close_rel(tl.numpy(), jl, REL)
        for k in ("k", "v"):
            _close_rel(tc[k].float().numpy(), jc[k], REL)


def test_greedy_engine_matches_reference(models):
    jm, jp, tm, tp = models
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
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    cache = tm.init_decode_state(2, 32, device="cpu")
    for tokens, cache_len, want in log:
        got, cache = tm.decode(tp, cache, torch.from_numpy(tokens),
                               cache_len)
        _close_rel(got.numpy(), want, REL)


# --------------------------------------------------------------------------
# the pieces: cross-attention, the encoder, the VLM's layout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_rope", [True, False])
def test_cross_attention_matches_reference(use_rope):
    jm, jp, tm, tp = _models("whisper-tiny")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, tm.cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 20, tm.cfg.d_model)).astype(np.float32)
    lp = {k: v[0] for k, v in jp["layers"]["xattn"].items()}
    tlp = {k: v[0] for k, v in tp["layers"]["xattn"].items()}
    pos = np.arange(12)
    want, _ = jattn.attention(
        jnp.asarray(x, jnp.bfloat16), lp, jm.cfg, positions=jnp.asarray(pos),
        causal=False, x_kv=jnp.asarray(kv, jnp.bfloat16), use_rope=use_rope)
    got, _ = attn.attention(
        torch.from_numpy(x).to(torch.bfloat16), tlp, tm.cfg,
        positions=torch.from_numpy(pos), causal=False,
        x_kv=torch.from_numpy(kv).to(torch.bfloat16), use_rope=use_rope)
    _close_rel(got.float().numpy(), np.asarray(want, np.float32), REL)
    # self-attention with use_rope=False ropes neither q nor k
    want, _ = jattn.attention(jnp.asarray(x, jnp.bfloat16), lp, jm.cfg,
                              positions=jnp.asarray(pos), use_rope=False)
    got, _ = attn.attention(torch.from_numpy(x).to(torch.bfloat16), tlp,
                            tm.cfg, positions=torch.from_numpy(pos),
                            use_rope=False)
    _close_rel(got.float().numpy(), np.asarray(want, np.float32), REL)


def test_encoder_matches_reference_and_is_bidirectional():
    jm, jp, tm, tp = _models("whisper-tiny")
    jb, tb = _batches(tm.cfg)
    want = jtf.encoder(jm.cfg, jp, jb["frames"].astype(jnp.bfloat16))
    got = tf.encoder(tm.cfg, tp, tb["frames"])
    _close_rel(got.float().numpy(), np.asarray(want, np.float32), REL)
    frames = tb["frames"].clone()
    frames[:, -1] += 1.0                     # the last frame moves frame 0
    moved = tf.encoder(tm.cfg, tp, frames)
    assert not torch.equal(moved[:, 0], got[:, 0])


def test_pallas_routes_self_attention_to_the_kernel_only(monkeypatch):
    """Under ``impl="pallas"`` the encoder's self-attention (non-causal)
    and the decoder's (causal) reach the kernel's entry point; the
    cross-attention takes the blockwise path, as in the reference."""
    _, _, tm, tp = _models("whisper-tiny")
    _, tb = _batches(tm.cfg)
    calls = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    with torch.no_grad():
        Model(tm.cfg, impl="pallas").loss(tp, tb)
    F = tm.cfg.audio_frames_default
    assert calls == [(False, F, F)] * tm.cfg.enc_layers \
        + [(True, S, S)] * tm.cfg.n_layers


@pytest.mark.parametrize("fault", ["patches after the tokens",
                                   "loss over the patch positions"])
def test_vlm_layout_faults_move_the_logits(fault, monkeypatch):
    """The logit check above sees a VLM whose patches follow the tokens,
    or whose loss takes the first rows."""
    jm, jp, tm, tp = _models("llava-next-mistral-7b")
    jb, tb = _batches(tm.cfg, seed=1)
    fakes = {"patches after the tokens": (
                 "vlm_prefix", lambda px, x: torch.cat([x, px], dim=1)),
             "loss over the patch positions": (
                 "text_rows", lambda h, n: h[:, :n])}
    monkeypatch.setattr(tf, *fakes[fault])
    got = _port_logits(tm, tp, tb, "naive")
    want = _jax_logits(jm, jp, jb, "naive")
    assert np.abs(got - want).max() > REL * np.abs(want).max()


def test_frontend_inputs_are_required():
    for name, key in (("whisper-tiny", "frames"),
                      ("llava-next-mistral-7b", "patches")):
        _, _, tm, tp = _models(name)
        _, tb = _batches(tm.cfg)
        del tb[key]
        with pytest.raises(KeyError, match=key):
            tm.loss(tp, tb)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name):
    """encdec and vlm: loss, gnorm, lr and the updated parameters and
    moments, from one carried mid-run state."""
    assert_train_pair_close(train_step_pair(name))
