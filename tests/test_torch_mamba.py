"""The port's Mamba2 family (mamba2-1.3b's smoke config) against the JAX
package: ``Model.loss`` for each ``impl``, ``decode_step`` and the greedy
serve engine.

Weights are the reference's ``init_params`` carried over with
``carry.params_from_jax`` (its f32 leaves stay f32); inputs come from
numpy with a fixed seed.  Tolerances, with their reasons:

- ``Model.loss``: rel 5e-4, as for the dense family (flipped bf16
  roundings of activations, averaged over the batch's tokens);
- forward and decode logits and the decode state: 2^-5 of the largest
  reference entry, as for the dense family (flips accumulate over the
  layers and the decode steps);
- greedy tokens: equal.

Decode runs the reference op by op (``jax.disable_jit()``), which keeps
every bf16 rounding the program writes.  Under ``jit`` XLA:CPU keeps some
bf16 intermediates in f32 (its excess-precision default), and the f32 SSM
state carries those differences from tick to tick, so the compiled
reference's decode logits leave the port's tolerance within a few ticks
while op by op they agree to about one bf16 ulp (ROADMAP §C).
"""
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
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_model import _close_rel, _tick_log  # noqa: E402

NAME = "mamba2-1.3b"
IMPLS = ["naive", "blockwise", "pallas"]
LOSS_RTOL = 5e-4
REL = 2.0 ** -5


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


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_logits_match_jax(models, impl):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    labs = rng.integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    want = float(JModel(jm.cfg, impl=impl, xent_chunk=16).loss(jp, jb))
    before = ssd_scan.launches
    got = Model(tm.cfg, impl=impl, xent_chunk=16).loss(tp, tb)
    assert ssd_scan.launches == before           # the CPU runs no kernel
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)

    x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
    x = jtf.backbone(jm.cfg, jp, x, positions=jnp.arange(40), causal=True,
                     impl=impl)
    h = jlayers.norm(x, jp["ln_f"], jm.cfg.norm)
    jl = np.asarray(jnp.einsum("bsd,vd->bsv", h, jp["embed"])
                    .astype(jnp.float32))
    tl = tf.lm_logits(tm.cfg, tp, tf.lm_hidden(
        tm.cfg, tp, torch.from_numpy(toks), impl=impl)).float().numpy()
    V = tm.cfg.vocab
    _close_rel(tl[..., :V], jl[..., :V], REL)


def test_logit_check_sees_a_wrong_ssd(models, monkeypatch):
    """The logit comparison above rejects a broken intra-chunk block."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab, (2, 40)).astype(np.int32)
    real = ssd_scan.ssd_intra_chunk

    def zeroed(*a, **kw):
        y, st, dc = real(*a, **kw)
        return torch.zeros_like(y), st, dc

    monkeypatch.setattr(ssd_scan, "ssd_intra_chunk", zeroed)
    got = tf.lm_logits(tm.cfg, tp, tf.lm_hidden(
        tm.cfg, tp, torch.from_numpy(toks), impl="pallas")).float().numpy()
    monkeypatch.undo()
    want = tf.lm_logits(tm.cfg, tp, tf.lm_hidden(
        tm.cfg, tp, torch.from_numpy(toks), impl="naive")).float().numpy()
    assert np.abs(got - want).max() > REL * np.abs(want).max()


def test_decode_step_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    B = 2
    jc = jm.init_decode_state(B, 16)
    tc = tm.init_decode_state(B, 16, device="cpu")
    assert set(tc) == {"ssm"} and tc["ssm"].dtype == torch.float32
    assert tuple(tc["ssm"].shape) == jc["ssm"].shape
    for t in range(10):
        toks = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit():
            jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        assert tl.dtype == torch.float32
        assert tuple(tl.shape) == (B, tm.cfg.vocab)
        _close_rel(tl.numpy(), jl, REL)
        _close_rel(tc["ssm"].numpy(), jc["ssm"], REL)


def test_greedy_engine_matches_jax_engine(models):
    """Two slots, three requests: the third refills a slot mid-run and,
    as in the reference, starts from the state the previous request left
    in that slot (``_fill_slots`` resets the position only)."""
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
    with jax.disable_jit():
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
        _close_rel(got.numpy(), want, REL)


def test_serve_entry_point_runs_the_ssm_family():
    from repro_torch.launch import serve
    res = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--requests", "3",
                      "--slots", "2", "--max-new", "3", "--device", "cpu"])
    assert res["tokens"] == 9
