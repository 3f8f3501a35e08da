"""The port's training path against the JAX package: the data pipeline,
AdamW and its schedules, ``make_train_step`` (one step per decoder-only
family from one carried ``(params, opt_state)``), microbatching, the remat
modes, ``launch/train.py``, and the kernels' refusal of autograd.

The reference runs op by op (``jax.disable_jit()``): compiled, XLA:CPU
keeps bf16 intermediates in f32 and moves the gradient norm of a smoke
config by ~2% (measured on hymba's), the SSM state carrying the drift.
Tolerances, with their reasons (``torch_compare``):

- ``SyntheticLM.batch``: bitwise (the same numpy calls);
- ``AdamW.update`` and the schedules, in f32: rel 1e-6 (the same f32
  formulas; torch may fuse ``a + alpha * b`` and XLA's ``pow``/``cos``
  may differ by an ulp);
- a train step: ``loss`` rel 5e-4 and ``gnorm`` rel 1e-3 (bf16
  activations rounded after sums taken in another order, as for
  ``Model.loss``; measured 4e-7 and 7.4e-5), ``lr`` rel 1e-6; the
  updated bf16 parameters: at most 2% of a leaf's entries off by more
  than 10% of their move plus two bf16 ulps (a gradient entry near zero
  whose sign two summation orders decide differently moves the other way;
  measured up to 0.78%, a layernorm bias of whisper's), each leaf's mean |p - p0| within
  1e-2, the f32 leaves within 1e-2 of the leaf's largest move, the moments
  within 2^-5 of the leaf's largest entry (measured 5e-3);
- microbatches 2 against 1, and the remat modes against ``none``: the
  port against itself; remat changes no number (bitwise), microbatches
  move the loss and gradients only by the f32 accumulation (rel 1e-3, the
  reference's own test holds 5e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs.base import ShapeSpec, get_config  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import (flash_attention, ops, rmsnorm,  # noqa: E402
                                 ssd_scan)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402
from torch_compare import (assert_train_pair_close,  # noqa: E402
                           train_step_pair)

REL = 1e-6


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,host_index,host_count", [
    (0, 0, 1), (3, 1, 2), (12345, 3, 4)])
def test_synthetic_lm_batches_bitwise(seed, host_index, host_count):
    kw = dict(vocab=1000, seq_len=24, global_batch=8, seed=seed,
              host_index=host_index, host_count=host_count)
    want = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = got.batch(step), want.batch(step)
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetcher_yields_the_steps_in_order():
    src = pipeline.SyntheticLM(pipeline.DataConfig(vocab=50, seq_len=8,
                                                   global_batch=2))
    pf = pipeline.Prefetcher(src, start_step=3, depth=2)
    for want in (3, 4, 5):
        step, b = next(pf)
        assert step == want
        np.testing.assert_array_equal(b["tokens"], src.batch(want)["tokens"])
    pf.close()


# --------------------------------------------------------------------------
# AdamW and the schedules
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_schedules_match_reference(kind):
    args = (3e-3, 5, 40)
    fn = getattr(optimizer, f"{kind}_schedule")(*args)
    jfn = getattr(jopt, f"{kind}_schedule")(*args)
    for step in range(0, 45):
        got = fn(step)
        want = float(jfn(jnp.int32(step)))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= REL * abs(want), (step, got, want)


def _tree(rng, shapes, scale=1.0, positive=False):
    out = {}
    for k, s in shapes.items():
        if isinstance(s, dict):
            out[k] = _tree(rng, s, scale, positive)
        else:
            a = rng.standard_normal(s).astype(np.float32) * scale
            out[k] = np.abs(a) if positive else a
    return out


SHAPES = {"embed": (16, 8), "layers": {"w": (2, 8, 8), "ln": {"w": (2, 8)}},
          "ln_f": {"w": (8,)}}


@pytest.mark.parametrize("clip,gscale", [(1.0, 1.0), (1.0, 1e-3),
                                         (0.0, 1.0)])
def test_adamw_update_matches_reference(clip, gscale):
    """f32 parameters, a mid-run state: the clip active (gnorm ~ 9),
    inactive (gnorm ~ 0.01) and switched off; decay on the 2-d leaves
    only (the stacked norm ``[L, d]`` included, ``ln_f`` not)."""
    rng = np.random.default_rng(0)
    p, g = _tree(rng, SHAPES), _tree(rng, SHAPES, gscale)
    m, v = _tree(rng, SHAPES, 1e-3), _tree(rng, SHAPES, 1e-5, True)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=clip)
    jo = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 3, 10), **kw)
    to = optimizer.AdamW(lr=optimizer.cosine_schedule(1e-2, 3, 10), **kw)
    jt = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    jp, jst, jmet = jo.update(jt(g), jopt.AdamWState(
        step=jnp.int32(4), m=jt(m), v=jt(v)), jt(p))
    tp_f32 = tf.unflatten((k, torch.from_numpy(a.copy()))
                          for k, a in tf.leaves(p))
    st = carry.opt_state_from_numpy(4, m, v, device="cpu")
    tg = tf.unflatten((k, torch.from_numpy(a)) for k, a in tf.leaves(g))
    out, st2, met = to.update(tg, st, tp_f32)
    assert out is tp_f32 and st2.step == 5 == int(jst.step)
    for k in ("gnorm", "lr"):
        assert abs(float(met[k]) - float(jmet[k])) <= REL * max(
            abs(float(jmet[k])), 1e-30), k
    for got, want in ((out, jp), (st2.m, jst.m), (st2.v, jst.v)):
        for (k, a), (_, b) in zip(tf.leaves(got), tf.leaves(want)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=REL,
                                       atol=REL * np.abs(b).max(),
                                       err_msg=k)


def test_adamw_keeps_bf16_parameters_and_carries_state():
    rng = np.random.default_rng(1)
    p = tf.unflatten((k, torch.from_numpy(a).to(torch.bfloat16))
                     for k, a in tf.leaves(_tree(rng, SHAPES)))
    g = tf.unflatten((k, torch.from_numpy(a).to(torch.bfloat16))
                     for k, a in tf.leaves(_tree(rng, SHAPES)))
    opt = optimizer.AdamW(lr=1e-2)
    st = opt.init(p)
    assert st.step == 0 and all(t.dtype == torch.float32 and not t.any()
                                for _, t in tf.leaves(st.m))
    out, st, _ = opt.update(g, st, p)
    assert all(t.dtype == torch.bfloat16 for _, t in tf.leaves(out))
    step, m, v = carry.opt_state_to_numpy(st)
    back = carry.opt_state_from_numpy(step, m, v, device="cpu")
    assert back.step == 1
    for (k, a), (_, b) in zip(tf.leaves(back.m), tf.leaves(st.m)):
        assert torch.equal(a, b), k


# --------------------------------------------------------------------------
# one train step against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-8b", "mixtral-8x22b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_train_step_matches_reference(name):
    """dense, moe, ssm and hybrid: loss, gnorm, lr and the updated
    parameters and moments, from one carried mid-run state."""
    assert_train_pair_close(train_step_pair(name))


def test_microbatches_match_reference():
    """Two sequential microbatches, gradients accumulated in f32, in both
    packages."""
    assert_train_pair_close(train_step_pair("granite-8b", B=4,
                                            microbatches=2))


def _grads(model, params, batch):
    names, ps = zip(*tf.leaves(params))
    alias = [p.detach().requires_grad_(True) for p in ps]
    loss = model.loss(tf.unflatten(zip(names, alias)), batch)
    return loss.detach(), torch.autograd.grad(loss, alias, allow_unused=True)


def _smoke(name, **kw):
    cfg = get_config(name).smoke()
    model = Model(cfg, xent_chunk=16, **kw)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = model.make_inputs(ShapeSpec("t", 32, 4, "train"),
                              torch.Generator().manual_seed(1))
    return cfg, model, params, batch


def test_microbatching_matches_single_batch():
    """The reference's ``test_microbatching_matches_single_batch``,
    mirrored: same loss and gradient norm."""
    cfg, model, params, batch = _smoke("granite-8b")
    opt = optimizer.AdamW(lr=1e-2)
    out = {}
    for n in (1, 2):
        p = tf.unflatten((k, t.clone()) for k, t in tf.leaves(params))
        _, _, m = loop.make_train_step(model, opt, loop.TrainConfig(
            microbatches=n))(p, opt.init(p), batch)
        out[n] = m
    for k in ("loss", "gnorm"):
        assert float(out[2][k]) == pytest.approx(float(out[1][k]), rel=1e-3)


@pytest.mark.parametrize("name", ["granite-8b", "hymba-1.5b",
                                  "whisper-tiny"])
def test_remat_modes_agree(name):
    """The reference's ``test_remat_modes_agree``, mirrored and held
    bitwise: recomputing the forward changes no number."""
    cfg, _, params, batch = _smoke(name)
    base = _grads(Model(cfg, xent_chunk=16), params, batch)
    for mode in ("dots", "full", "block"):
        loss, grads = _grads(Model(cfg, xent_chunk=16, remat=mode), params,
                             batch)
        assert torch.equal(loss, base[0]), mode
        for a, b in zip(grads, base[1]):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), mode


def test_remat_dots_saves_only_unbatched_products():
    """``dots`` keeps the ``mm`` outputs and recomputes the rest: its
    backward recomputes the ``bmm`` of attention and no ``mm``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg, _, params, batch = _smoke("granite-8b")

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[func] = self.n.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    runs = {}
    for mode in ("none", "dots", "full"):
        with Count() as c:
            _grads(Model(cfg, xent_chunk=16, remat=mode), params, batch)
        runs[mode] = c.n
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert runs["dots"][mm] == runs["none"][mm] < runs["full"][mm]
    assert runs["none"][bmm] < runs["dots"][bmm] == runs["full"][bmm]


def test_remat_rejects_unknown_mode():
    cfg, _, params, batch = _smoke("granite-8b")
    with pytest.raises(ValueError, match="remat"):
        _grads(Model(cfg, remat="everything"), params, batch)


# --------------------------------------------------------------------------
# the kernels refuse autograd (no silent gradient drop)
# --------------------------------------------------------------------------

def test_kernels_refuse_autograd_on_the_cpu_route():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 16, 8, generator=g) for _ in range(3))
    with pytest.raises(RuntimeError, match="blockwise"):
        flash_attention.flash_attention_bhsd(q.requires_grad_(), k, v)
    with torch.no_grad():
        flash_attention.flash_attention_bhsd(q, k, v)
    flash_attention.flash_attention_bhsd(q.detach(), k, v)
    x = torch.randn(2, 1, 8, 4, generator=g)
    dt = torch.rand(2, 1, 8, generator=g)
    A = -torch.rand(2, generator=g)
    B, C = (torch.randn(2, 1, 8, 4, generator=g) for _ in range(2))
    with pytest.raises(RuntimeError, match="blockwise"):
        ssd_scan.ssd_intra_chunk(x, dt, A.requires_grad_(), B, C)
    ssd_scan.ssd_intra_chunk(x, dt, A.detach(), B, C)
    xr, w = torch.randn(4, 8, generator=g), torch.ones(8)
    with pytest.raises(RuntimeError, match="ops.rmsnorm"):
        rmsnorm.rmsnorm_2d(xr, w.requires_grad_())
    # ops.rmsnorm keeps its analytic backward
    xg = xr.clone().requires_grad_()
    ops.rmsnorm(xg, w).sum().backward()
    assert xg.grad is not None and w.grad is not None


@pytest.mark.parametrize("name", ["granite-8b", "mamba2-1.3b"])
def test_pallas_training_step_raises(name):
    """A training step through the kernels' path raises instead of
    dropping the attention's or the SSM's gradients; blockwise trains."""
    cfg, _, params, batch = _smoke(name)
    opt = optimizer.AdamW(lr=1e-2)
    step = loop.make_train_step(Model(cfg, impl="pallas", xent_chunk=16),
                                opt)
    with pytest.raises(RuntimeError, match="impl='blockwise'"):
        step(params, opt.init(params), batch)
    with torch.no_grad():                 # the forward alone still runs
        Model(cfg, impl="pallas", xent_chunk=16).loss(params, batch)


# --------------------------------------------------------------------------
# launch/train.py
# --------------------------------------------------------------------------

def test_launch_train_smoke_descends(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "12", "--batch", "4",
            "--seq", "32", "--log-every", "4"]
    out = launch_train.main(argv)
    losses = out["losses"]
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0]
    assert out["wall_s"] > 0 and len(out["step_s"]) == 12
    text = capsys.readouterr().out
    assert "arch=hymba-1.5b-smoke" in text and "final loss" in text
    # the same run under the restart supervisor, with checkpoints
    ck = launch_train.main(argv + ["--ckpt-dir", str(tmp_path),
                                   "--ckpt-every", "5"])
    assert ck["losses"] == losses
    assert ck["restarts"] == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000005", "step_0000000010"]
