"""The port's MoE family (``models/moe.py``; mixtral-8x22b and dbrx-132b
smoke configs) against the JAX package: the expert FFN alone, the
parameter tree, ``Model.loss`` for each ``impl``, ``decode_step``, the
greedy serve engine and ``launch/serve.py``.

Which (token, expert) assignments a layer drops for capacity is an integer
result: it must equal the reference's exactly, and so must the top-k
experts of every token (``torch_compare.jax_moe_probe`` reads them from
the reference's own run).  Tolerances, with their reasons:

- ``moe_ff`` in bf16: 2^-7 of the largest reference entry, and at least
  99% of the entries bitwise equal.  Every step rounds where the reference
  rounds, but the matrix products sum their f32 terms in another order, so
  a bf16 rounding of an intermediate can flip;
- the combine alone (``moe.combine``) in bf16: bitwise equal to the
  reference's scatter-add, for dbrx's k = 4, where the order of the adds
  matters;
- ``moe_ff`` in f32: 1e-5 of the largest reference entry (the matrix
  products sum in another order);
- ``moe_ff`` against ``moe_ff_dense_reference`` (capacity factor 8, no
  drops): 1e-4, the reference's own bound (``test_archs_smoke.py``);
- ``Model.loss``: rel 5e-4 and logits 2^-5 of the largest entry, as for
  the dense family (flipped bf16 roundings of activations).

The model-level comparisons run the reference op by op
(``jax.disable_jit()``).  Compiled, XLA:CPU keeps some bf16 intermediates
in f32, so a router logit can round the other way; where two experts are
near a tie at the top-k boundary that moves a token to another expert, and
its output by its whole scale; op by op the routing is equal.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from test_torch_model import _close_rel, _tick_log  # noqa: E402
from torch_compare import jax_moe_probe, port_moe_probe  # noqa: E402

MOE = ["mixtral-8x22b", "dbrx-132b"]
IMPLS = ["naive", "blockwise", "pallas"]
LOSS_RTOL = 5e-4
REL = 2.0 ** -5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(name, **kw):
    return (jbase.get_config(name).smoke().scaled(**kw),
            base.get_config(name).smoke().scaled(**kw))


def _layer(cfg, seed=0, skew=2.0, tokens=(2, 64)):
    """Seeded expert weights (std fan_in^-0.5) and an input whose tokens
    share a component (``skew`` times a fixed direction), so that the
    router favours some experts and capacity drops happen."""
    rng = np.random.default_rng(seed)
    p = {k: rng.standard_normal(s).astype(np.float32) * s[-2] ** -0.5
         for k, s in moe.moe_shapes(cfg).items()}
    x = rng.standard_normal(tokens + (cfg.d_model,)).astype(np.float32)
    x += np.float32(skew) * rng.standard_normal(cfg.d_model).astype(
        np.float32)
    return x, p


def _both(x, p, jcfg, cfg, dtype, fn="moe_ff"):
    jd, td = DTYPES[dtype]
    probe = fn == "moe_ff"
    with (jax_moe_probe() if probe else contextlib.nullcontext([])) \
            as jcalls:
        jy = getattr(jmoe, fn)(jnp.asarray(x, jd),
                               {k: jnp.asarray(v, jd) for k, v in p.items()},
                               jcfg)
    with (port_moe_probe() if probe else contextlib.nullcontext([])) \
            as tcalls:
        ty = getattr(moe, fn)(torch.from_numpy(x).to(td),
                              {k: torch.from_numpy(v).to(td)
                               for k, v in p.items()}, cfg)
    assert ty.dtype == td and tuple(ty.shape) == x.shape
    return (np.asarray(jy.astype(jnp.float32)), ty.float().numpy(),
            jcalls, tcalls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE)
def test_moe_ff_matches_jax_with_drops(name, dtype):
    jcfg, cfg = _cfgs(name)
    assert cfg.capacity_factor == 1.25
    x, p = _layer(cfg)
    jy, ty, jc, tc = _both(x, p, jcfg, cfg, dtype)
    assert len(jc) == len(tc) == 1
    assert jc[0]["cap"] == tc[0]["cap"] == moe.capacity(cfg, 128)
    np.testing.assert_array_equal(tc[0]["experts"], jc[0]["experts"])
    assert len(jc[0]["dropped"]) > 0                 # the case has drops
    assert tc[0]["dropped"] == jc[0]["dropped"]
    if dtype == "bfloat16":
        assert (ty == jy).mean() >= 0.99
        _close_rel(ty, jy, 2.0 ** -7)
    else:
        _close_rel(ty, jy, 1e-5)


@pytest.mark.parametrize("name", MOE)
def test_moe_ff_matches_dense_reference_without_drops(name):
    """The reference's own case (``test_archs_smoke.py``): capacity factor
    8, so no assignment is dropped and the sort-based dispatch equals every
    expert computing every token."""
    jcfg, cfg = _cfgs(name, capacity_factor=8.0)
    x, p = _layer(cfg, seed=1, skew=0.0, tokens=(2, 16))
    tx = torch.from_numpy(x)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with port_moe_probe() as tc:
        y = moe.moe_ff(tx, tp, cfg).numpy()
    assert tc[0]["dropped"] == []
    y_dense = moe.moe_ff_dense_reference(tx, tp, cfg).numpy()
    np.testing.assert_allclose(y, y_dense, rtol=1e-4, atol=1e-4)
    jd, td, _, _ = _both(x, p, jcfg, cfg, "float32",
                         fn="moe_ff_dense_reference")
    _close_rel(td, jd, 1e-5)


def test_dbrx_top4_combine_adds_in_the_references_order():
    """dbrx's routing (16 experts, top-4): the combine of the same bf16
    contributions is bitwise the reference's scatter-add
    ``zeros.at[token].add(y_sorted)``; with k = 4 the order of the adds
    matters, and summing each token's contributions in top-k order instead
    gives other bits.  Then the whole layer at smoke width, with drops."""
    rng = np.random.default_rng(4)
    T, E, k, d = 96, 16, 4, 64
    experts = torch.from_numpy(np.argsort(rng.random((T, E)), -1)[:, :k])
    plan = moe.dispatch_plan(experts, E, moe.capacity(
        base.get_config("dbrx-132b").scaled(n_experts=E, top_k=k), T))
    y_sorted = torch.from_numpy(
        rng.standard_normal((T * k, d)).astype(np.float32)
        * 2.0 ** rng.integers(-6, 6, (T * k, 1))).to(torch.bfloat16)
    want = jnp.zeros((T, d), jnp.bfloat16).at[
        jnp.asarray(plan.token.numpy())].add(
        jnp.asarray(y_sorted.float().numpy(), jnp.bfloat16))
    got = moe.combine(y_sorted, plan, experts)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    slot = torch.empty_like(plan.order)
    slot[plan.order] = torch.arange(T * k)
    at = slot.view(T, k)                      # each token's top-k order
    by_prob = y_sorted[at[:, 0]]
    for j in range(1, k):
        by_prob = by_prob + y_sorted[at[:, j]]
    assert not torch.equal(by_prob, got)

    jcfg, cfg = _cfgs("dbrx-132b", n_experts=16, top_k=4)
    x, p = _layer(cfg, seed=2)
    jy, ty, jc, tc = _both(x, p, jcfg, cfg, "bfloat16")
    assert len(jc[0]["dropped"]) > 0
    assert tc[0]["dropped"] == jc[0]["dropped"]
    _close_rel(ty, jy, 2.0 ** -7)


def test_planted_tie_takes_the_lower_expert():
    """Experts 1 and 2 get identical router columns, so every token's
    probabilities for them tie.  ``jax.lax.top_k`` takes the lower index
    first; so must the port, wherever the tie sits at the top-k boundary,
    and a top-k that breaks ties toward the higher index is caught."""
    jcfg, cfg = _cfgs("mixtral-8x22b")
    x, p = _layer(cfg, seed=3, skew=0.0)
    p["router"][:, 2] = p["router"][:, 1]
    jy, ty, jc, tc = _both(x, p, jcfg, cfg, "bfloat16")
    je = jc[0]["experts"]
    at_edge = ((je[:, -1] == 1) & ~(je == 2).any(-1))
    assert at_edge.sum() > 0                 # ties on the top-k boundary
    np.testing.assert_array_equal(tc[0]["experts"], je)
    assert tc[0]["dropped"] == jc[0]["dropped"]
    np.testing.assert_array_equal(ty, jy)

    real = moe.top_k

    def higher_first(probs, k):
        vals, idx = real(probs.flip(-1), k)
        return vals, probs.shape[-1] - 1 - idx

    moe.top_k = higher_first
    try:
        with port_moe_probe() as bad:
            moe.moe_ff(torch.from_numpy(x).to(torch.bfloat16),
                       {k: torch.from_numpy(v).to(torch.bfloat16)
                        for k, v in p.items()}, cfg)
    finally:
        moe.top_k = real
    assert (bad[0]["experts"][at_edge] == 2).any(-1).all()


@pytest.mark.parametrize("T,cf,E,k", [(128, 1.25, 4, 2), (8192, 1.25, 8, 2),
                                      (512, 1.25, 8, 2), (7, 1.1, 16, 4),
                                      (3, 0.1, 8, 2), (1000, 1.3, 16, 4)])
def test_capacity_is_the_references(T, cf, E, k):
    """``moe.capacity`` against the capacity the reference's ``moe_ff``
    gives its dispatch buffer (read by the probe) for T tokens: Python
    float arithmetic, copied exactly."""
    jcfg, cfg = _cfgs("dbrx-132b", capacity_factor=cf, n_experts=E,
                      top_k=k, d_model=8, d_ff=8)
    x, p = _layer(cfg, seed=5, tokens=(1, T))
    with jax_moe_probe() as calls:
        jmoe.moe_ff(jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()},
                    jcfg)
    assert moe.capacity(cfg, T) == calls[0]["cap"]


@pytest.mark.parametrize("name", ["hymba-1.5b", "mixtral-8x22b",
                                  "dbrx-132b"])
def test_param_shapes_follow_the_references_tree(name):
    """Leaf names, order (JAX's flattening order) and shapes equal the
    reference's ``param_specs``, at smoke size and at full size."""
    for smoke in (True, False):
        jcfg = jbase.get_config(name)
        cfg = base.get_config(name)
        if smoke:
            jcfg, cfg = jcfg.smoke(), cfg.smoke()
        flat = jax.tree_util.tree_flatten_with_path(
            jtf.param_specs(jcfg),
            is_leaf=lambda v: isinstance(v, jax.ShapeDtypeStruct))[0]
        want = [(jax.tree_util.keystr(p), tuple(s.shape)) for p, s in flat]
        assert list(tf.leaves(tf.param_shapes(cfg))) == want


def _models(name):
    jcfg, cfg = _cfgs(name)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = carry.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, Model(cfg), tp


@pytest.fixture(scope="module", params=MOE)
def models(request):
    return _models(request.param)


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_logits_and_drops_match_jax(models, impl):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.cfg.vocab, (2, 48)).astype(np.int32)
    labs = rng.integers(0, tm.cfg.vocab, (2, 48)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    with jax.disable_jit(), jax_moe_probe() as jc:
        want = float(JModel(jm.cfg, impl=impl, xent_chunk=16).loss(jp, jb))
    with port_moe_probe() as tc:
        got = Model(tm.cfg, impl=impl, xent_chunk=16).loss(tp, tb)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    assert len(jc) == len(tc) == tm.cfg.n_layers
    assert sum(len(c["dropped"]) for c in jc) > 0
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(t["experts"], j["experts"])
        assert t["dropped"] == j["dropped"]

    with jax.disable_jit():
        x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
        x = jtf.backbone(jm.cfg, jp, x, positions=jnp.arange(48),
                         causal=True, impl=impl)
        from repro.models.layers import norm
        h = norm(x, jp["ln_f"], jm.cfg.norm)
        jl = np.asarray(jnp.einsum("bsd,vd->bsv", h, jp["unembed"])
                        .astype(jnp.float32))
    tl = tf.lm_logits(tm.cfg, tp, tf.lm_hidden(
        tm.cfg, tp, torch.from_numpy(toks), impl=impl)).float().numpy()
    V = tm.cfg.vocab
    _close_rel(tl[..., :V], jl[..., :V], REL)


def test_decode_step_matches_jax(models):
    """Decode routes the slots' tokens together: T = B tokens, capacity
    ``int(1.25 * B * k / E) + 1``, so a tick can drop assignments too."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    B = 3
    jc = jm.init_decode_state(B, 16)
    tc = tm.init_decode_state(B, 16, device="cpu")
    assert set(tc) == {"k", "v"}
    drops = 0
    for t in range(12):
        toks = rng.integers(0, tm.cfg.vocab, (B, 1)).astype(np.int32)
        with jax.disable_jit(), jax_moe_probe() as jcalls:
            jl, jc = jm.decode(jp, jc, jnp.asarray(toks), jnp.int32(t))
        with port_moe_probe() as tcalls:
            tl, tc = tm.decode(tp, tc, torch.from_numpy(toks), t)
        for j, c in zip(jcalls, tcalls):
            np.testing.assert_array_equal(c["experts"], j["experts"])
            assert c["dropped"] == j["dropped"]
            drops += len(j["dropped"])
        _close_rel(tl.numpy(), jl, REL)
        for k in ("k", "v"):
            _close_rel(tc[k].float().numpy(), jc[k], REL)
    assert drops > 0


def test_greedy_engine_matches_jax_engine(models):
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
    cache = tm.init_decode_state(2, 32, device="cpu")
    assert len(log) > 10
    for tokens, cache_len, want in log:
        got, cache = tm.decode(tp, cache, torch.from_numpy(tokens),
                               cache_len)
        _close_rel(got.numpy(), want, REL)


def test_serve_entry_point_runs_the_moe_family():
    from repro_torch.launch import serve
    res = serve.main(["--arch", "mixtral-8x22b", "--smoke", "--requests",
                      "3", "--slots", "2", "--max-new", "3", "--device",
                      "cpu"])
    assert res["tokens"] == 9


def test_numpy_params_draw_large_leaves_in_blocks(monkeypatch):
    """A leaf above ``carry.BLOCKED`` values is drawn block by block from
    seeds of its own (threads, same values whatever their schedule);
    ``leaf_fn`` sees every leaf as it is drawn; ``ones_jitter`` draws the
    leaves the reference fills with ones, and only those."""
    cfg = base.get_config("mixtral-8x22b").smoke()
    monkeypatch.setattr(carry, "BLOCKED", 1000)
    monkeypatch.setattr(carry, "BLOCK", 700)
    seen = []
    a = carry.numpy_params(cfg, 5, leaf_fn=lambda n, v: seen.append(n) or v)
    b = carry.numpy_params(cfg, 5)
    assert seen == [n for n, _ in tf.leaves(tf.param_shapes(cfg))]
    for (n, x), (_, y) in zip(tf.leaves(a), tf.leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=n)
    w = a["layers"]["ffn"]["w_in"]                 # 2 x 4 x 64 x 128 values
    flat = w.reshape(-1)
    i = list(tf.leaves(tf.param_shapes(cfg))).index(
        ("['layers']['ffn']['w_in']", w.shape))
    block1 = np.random.default_rng([5, i, 1]).standard_normal(
        700, dtype=np.float32) * np.float32(cfg.d_model ** -0.5)
    np.testing.assert_array_equal(flat[700:1400], carry.round_bf16(block1))
    assert abs(w.std() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert np.array_equal(carry.round_bf16(w), w)

    j = carry.numpy_params(cfg, 5, ones_jitter=0.5)
    for n, x in tf.leaves(j):
        if tf.init_rule(n, x.shape) == ("fill", 1.0):
            assert 0.3 < x.std() < 0.7 and abs(x.mean() - 1) < 0.2, n
        elif tf.init_rule(n, x.shape)[0] == "fill":
            assert np.all(x == 0.0), n
    assert not np.array_equal(j["layers"]["ln1"]["w"],
                              j["layers"]["ln2"]["w"])


def test_unrounded_leaves_cast_to_the_same_parameters(monkeypatch):
    """``rounded=False`` with ``carry.leaf_to_device`` (torch's cast to
    bf16, round to nearest even) gives the same parameters, bit for bit,
    as the rounded leaves through ``params_from_jax``, blocked leaves and
    jittered norms included."""
    cfg = base.get_config("hymba-1.5b").smoke()
    monkeypatch.setattr(carry, "BLOCKED", 5000)
    monkeypatch.setattr(carry, "BLOCK", 999)
    want = carry.params_from_jax(
        carry.numpy_params(cfg, 7, ones_jitter=0.3), device="cpu")
    got = carry.numpy_params(
        cfg, 7, ones_jitter=0.3, rounded=False,
        leaf_fn=lambda n, a: carry.leaf_to_device(n, a, "cpu"))
    for (n, a), (_, b) in zip(tf.leaves(want), tf.leaves(got)):
        assert a.dtype == b.dtype, n
        assert torch.equal(a, b), n


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("name", MOE)
def test_group_local_dispatch_matches_jax(name, groups):
    """``specs=(None, None, G)``: G dispatch groups of T / G tokens, each
    with the capacity of its own tokens, against the reference's
    ``moe_ff`` with the same ``specs`` (no mesh: its constraints are
    no-ops).  The top-k experts and the dropped assignments equal the
    reference's exactly; the output is held as in the one-group case."""
    jcfg, cfg = _cfgs(name)
    x, p = _layer(cfg, seed=6)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    with jax_moe_probe() as jc:
        jy = jmoe.moe_ff(jnp.asarray(x, jnp.bfloat16),
                         {k: jnp.asarray(v, jnp.bfloat16)
                          for k, v in p.items()}, jcfg,
                         specs=(None, None, groups))
    with port_moe_probe() as tc:
        ty = moe.moe_ff(tx, tp, cfg, specs=(None, None, groups))
    jy = np.asarray(jy.astype(jnp.float32))
    assert jc[0]["groups"] == tc[0]["groups"] == groups
    assert jc[0]["cap"] == tc[0]["cap"] == moe.capacity(cfg, 128 // groups)
    np.testing.assert_array_equal(tc[0]["experts"], jc[0]["experts"])
    assert len(jc[0]["dropped"]) > 0
    assert tc[0]["dropped"] == jc[0]["dropped"]
    assert (ty.float().numpy() == jy).mean() >= 0.99
    _close_rel(ty.float().numpy(), jy, 2.0 ** -7)
    # the groups change which assignments are dropped
    with port_moe_probe() as one:
        moe.moe_ff(tx, tp, cfg)
    assert one[0]["dropped"] != tc[0]["dropped"]


def test_one_group_is_bitwise_the_default():
    """``specs=(None, None, 1)`` is the same computation as no ``specs``,
    bit for bit, and a token count that G does not divide raises."""
    _, cfg = _cfgs("dbrx-132b")
    x, p = _layer(cfg, seed=7)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    assert torch.equal(moe.moe_ff(tx, tp, cfg),
                       moe.moe_ff(tx, tp, cfg, specs=(None, None, 1)))
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ff(tx, tp, cfg, specs=(None, None, 3))
