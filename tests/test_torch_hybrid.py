"""The port's hybrid family (hymba-1.5b's smoke config: attention and SSM
heads in parallel, averaged; sliding window 32) against the JAX package:
``Model.loss`` and the forward's logits for each ``impl``, the decode
state, ``decode_step`` past the window (the KV ring buffer wraps), the
greedy serve engine and ``launch/serve.py``'s default arch.

Weights are the reference's ``init_params`` carried over with
``carry.params_from_jax``, or ``carry.numpy_params`` with its norm weights
drawn apart (``ones_jitter``) where a check must tell ``ln1`` from
``ln_ssm``.  Tolerances, with their reasons:

- ``Model.loss``: rel 5e-4, as for the dense and SSM families (flipped
  bf16 roundings of activations, averaged over the batch's tokens);
- forward and decode logits, the KV cache and the SSM state: 2^-5 of the
  largest reference entry, as for the other families;
- greedy tokens: equal.

The reference runs op by op (``jax.disable_jit()``), as the SSM family's
decode does: compiled (the layers' ``lax.scan``), XLA:CPU keeps some bf16
intermediates in f32, and the f32 SSM state carries that difference along
the sequence and from tick to tick (compiled, some forward logits leave
2^-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import flash_attention, ssd_scan  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_model import _close_rel, _tick_log  # noqa: E402

NAME = "hymba-1.5b"
IMPLS = ["naive", "blockwise", "pallas"]
LOSS_RTOL = 5e-4
REL = 2.0 ** -5
S = 48                     # past the smoke window (32), 6 SSM chunks of 8


def _models():
    jcfg = jbase.get_config(NAME).smoke()
    cfg = base.get_config(NAME).smoke()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = carry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _tokens(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (2, S)).astype(np.int32),
            rng.integers(0, vocab, (2, S)).astype(np.int32))


def _jax_logits(jm, jp, toks, impl):
    with jax.disable_jit():
        return _jax_logits_op_by_op(jm, jp, toks, impl)


def _jax_logits_op_by_op(jm, jp, toks, impl):
    x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
    x = jtf.backbone(jm.cfg, jp, x, positions=jnp.arange(toks.shape[1]),
                     causal=True, impl=impl)
    h = jlayers.norm(x, jp["ln_f"], jm.cfg.norm)
    return np.asarray(jnp.einsum("bsd,vd->bsv", h, jp["embed"])
                      .astype(jnp.float32))[..., :jm.cfg.vocab]


def _port_logits(cfg, tp, toks, impl):
    return tf.lm_logits(cfg, tp, tf.lm_hidden(
        cfg, tp, torch.from_numpy(toks), impl=impl)).float().numpy()[
        ..., :cfg.vocab]


def test_config_is_the_hybrid_family():
    cfg = base.get_config(NAME)
    assert cfg.family == "hybrid" and cfg.has_attention and cfg.has_ssm
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == (64, 50, 16)
    # hymba's SSM heads take the tensor-core SSD kernel (P 50: x loaded by
    # the threads, not TMA), its attention the tensor-core flash kernel
    # (bf16, hd 64)
    bf, f32 = torch.bfloat16, torch.float32
    assert ssd_scan.route((bf, f32, f32, bf, bf), cfg.ssm_chunk,
                          cfg.ssm_head_dim, cfg.ssm_state) == "tensor_core"
    assert flash_attention.route(bf, cfg.hd) == "tensor_core"


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_logits_match_jax(models, impl):
    jm, jp, tm, tp = models
    toks, labs = _tokens(tm.cfg.vocab)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    with jax.disable_jit():
        want = float(JModel(jm.cfg, impl=impl, xent_chunk=16).loss(jp, jb))
    before = (ssd_scan.launches, flash_attention.launches)
    got = Model(tm.cfg, impl=impl, xent_chunk=16).loss(tp, tb)
    assert (ssd_scan.launches, flash_attention.launches) == before
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    _close_rel(_port_logits(tm.cfg, tp, toks, impl),
               _jax_logits(jm, jp, toks, impl), REL)


def test_pallas_impl_reaches_both_kernel_wrappers(models, monkeypatch):
    """With ``impl="pallas"`` each layer calls the flash wrapper once (its
    window the config's) and the SSD wrapper once, with hymba's group of
    heads sharing B and C (``heads``); on CPU tensors both take their plain
    versions."""
    jm, jp, tm, tp = models
    seen = []
    real_fa, real_ssd = flash_attention.flash_attention_bhsd, \
        ssd_scan.ssd_intra_chunk

    def fa(q, k, v, **kw):
        seen.append(("flash", kw["window"], tuple(q.shape)))
        return real_fa(q, k, v, **kw)

    def ssd(x, *a, **kw):
        seen.append(("ssd", kw["heads"], tuple(x.shape)))
        return real_ssd(x, *a, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention_bhsd", fa)
    monkeypatch.setattr(ssd_scan, "ssd_intra_chunk", ssd)
    toks, _ = _tokens(tm.cfg.vocab)
    tf.lm_hidden(tm.cfg, tp, torch.from_numpy(toks), impl="pallas")
    c = tm.cfg
    H = c.ssm_heads
    assert seen == [("flash", c.sliding_window, (2 * c.n_heads, S, c.hd)),
                    ("ssd", H, (2 * H, S // c.ssm_chunk, c.ssm_chunk,
                                c.ssm_head_dim))] * c.n_layers


def _jittered(cfg_t, cfg_j):
    """``numpy_params`` with the norm weights drawn apart, for both."""
    npp = carry.numpy_params(cfg_t, seed=1, ones_jitter=0.5)
    tp = carry.params_from_jax(npp, device="cpu")
    jp = tf.unflatten(
        (n, jnp.asarray(a, jnp.float32 if tf.is_f32_leaf(n)
                        else jnp.bfloat16)) for n, a in tf.leaves(npp))
    return jp, tp


@pytest.mark.parametrize("fault", ["a + s", "ln1 for the SSM heads"])
def test_logit_check_sees_a_wrong_hybrid_layer(models, fault, monkeypatch):
    """With norm weights that differ, the port equals the reference, and
    the logit comparison rejects each fault of the hybrid layer: the heads
    summed rather than averaged, or the SSM heads normed with ``ln1``."""
    jm, _, tm, _ = models
    jp, tp = _jittered(tm.cfg, jm.cfg)
    toks, _ = _tokens(tm.cfg.vocab, seed=2)
    want = _jax_logits(jm, jp, toks, "naive")
    _close_rel(_port_logits(tm.cfg, tp, toks, "naive"), want, REL)
    if fault == "a + s":
        monkeypatch.setattr(tf, "mix_heads", lambda a, s: a + s)
    else:
        layers = dict(tp["layers"], ln_ssm=tp["layers"]["ln1"])
        tp = dict(tp, layers=layers)
    got = _port_logits(tm.cfg, tp, toks, "naive")
    assert np.abs(got - want).max() > REL * np.abs(want).max()


def test_decode_state_holds_kv_ring_and_ssm_state(models):
    jm, jp, tm, tp = models
    for seq in (16, 100):
        jc = jm.init_decode_state(3, seq)
        tc = tm.init_decode_state(3, seq, device="cpu")
        assert set(tc) == set(jc) == {"k", "v", "ssm"}
        for k in tc:
            assert tuple(tc[k].shape) == jc[k].shape, (seq, k)
            assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype)
            assert not tc[k].any()
    # the window bounds the KV cache, not the SSM state
    assert tc["k"].shape[2] == tm.cfg.sliding_window == 32


def test_decode_step_matches_jax_past_the_window(models):
    """40 steps over a 32-slot ring buffer: positions 32-39 overwrite the
    oldest slots."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    B = 2
    jc = jm.init_decode_state(B, 64)
    tc = tm.init_decode_state(B, 64, device="cpu")
    for t in range(40):
        toks = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        assert tl.dtype == torch.float32
        assert tuple(tl.shape) == (B, tm.cfg.vocab)
        _close_rel(tl.numpy(), jl, REL)
        for k in ("k", "v", "ssm"):
            _close_rel(tc[k].float().numpy(), jc[k], REL)


def test_greedy_engine_matches_jax_engine(models):
    """Two slots, three requests (the third refills a slot and keeps the
    SSM state its predecessor left, as in the reference); 30 new tokens,
    so decode runs past the 32-slot window."""
    jm, jp, tm, tp = models
    prompts = [[5, 6, 7], [9, 8, 7, 6, 5], [1, 2]]
    jeng = jengine.Engine(jm, jp, slots=2, max_seq=64)
    log = _tick_log(jeng)
    teng = Engine(tm, tp, slots=2, max_seq=64)
    jreqs = [jengine.Request(rid=i, prompt=p, max_new=30)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new=30)
             for i, p in enumerate(prompts)]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    with jax.disable_jit():
        jeng.run(max_ticks=200)
    teng.run(max_ticks=200)
    assert all(r.done and len(r.out) == 30 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    cache = tm.init_decode_state(2, 64, device="cpu")
    assert max(c for _, c, _ in log) > tm.cfg.sliding_window
    for tokens, cache_len, want in log:
        got, cache = tm.decode(tp, cache, torch.from_numpy(tokens),
                               cache_len)
        _close_rel(got.numpy(), want, REL)


def test_serve_entry_point_defaults_to_hymba(monkeypatch):
    """``launch/serve.py`` with no ``--arch`` serves the reference's
    default, hymba-1.5b."""
    from repro_torch.launch import serve
    asked = []
    monkeypatch.setattr(serve, "get_config",
                        lambda name: asked.append(name) or
                        base.get_config(name))
    res = serve.main(["--smoke", "--requests", "3", "--slots", "2",
                      "--max-new", "3", "--device", "cpu"])
    assert asked == [NAME]
    assert res["tokens"] == 9
