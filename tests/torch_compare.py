"""Comparisons shared by the port's differential tests (``test_torch_*``).

- ``assert_states_equal``: every ``SimState`` leaf (name, dtype, shape and
  value) of the port equals the JAX engine's exactly;
- ``assert_metrics_equal``: two ``Metrics`` agree field by field —
  integers (and lists of them) exactly, floats within rel 1e-6 (the energy
  terms are float32 sums taken in another order than XLA's), NaN = NaN;
- ``assert_tables_equal``: two host-side dataclasses (traffic tables,
  traces, device maps) are equal array for array, dtypes included;
- ``jax_moe_probe`` / ``port_moe_probe``: each MoE layer call's top-k
  experts and the (token, expert) assignments it dropped for capacity, in
  the reference and in the port.
"""
import contextlib
import dataclasses
import enum
import math

import numpy as np

REL = 1e-6


def np_tree(tree) -> dict:
    """A NamedTuple of (JAX or torch) arrays -> ``{name: np.ndarray}``.

    uint32 leaves (the reference's ``SimStatic.phy_seed``) come back as
    int64, the dtype the port holds them in (torch has no uint32
    arithmetic); their values are unchanged."""
    out = {}
    for k, v in tree._asdict().items():
        a = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
        out[k] = a.astype(np.int64) if a.dtype == np.uint32 else a
    return out


def assert_states_equal(want: dict, got: dict, skip=()):
    assert list(got) == list(want)
    for k in want:
        if k in skip:
            continue
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(a, b, path):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, bool) or isinstance(a, (int, np.integer, str)):
        assert a == b, (path, a, b)
    elif isinstance(a, float):
        assert (math.isnan(a) and math.isnan(b)) or \
            math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def assert_metrics_equal(got, want):
    """``got``/``want``: ``Metrics`` or ``dataclasses.asdict`` of one."""
    g = got if isinstance(got, dict) else dataclasses.asdict(got)
    w = want if isinstance(want, dict) else dataclasses.asdict(want)
    _close(w, g, "metrics")


def _same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{what}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (what, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, enum.Enum):
        assert int(a) == int(b), what
    else:
        assert a == b, (what, a, b)


def assert_tables_equal(a, b, what="table"):
    _same(a, b, what)


# ---- engine helpers: carry JAX-packed points and states into the port
# (only the tests import both packages)


def port_packed(ps):
    """A JAX ``PackedSim`` as the port's (tables carried to the CPU)."""
    from repro_torch import carry
    from repro_torch.core import simulator as tsim
    return tsim.PackedSim(
        ss=carry.static_from_numpy(np_tree(ps.ss), "cpu"), B=ps.B,
        n_cores=ps.n_cores, Lw=ps.Lw, n_inj=ps.n_inj, topo=ps.topo,
        rt=ps.rt, phy=ps.phy, sim=ps.sim, dims=ps.dims, mem_on=ps.mem_on,
        mc_on=bool(np.asarray(ps.ss.mc_member).any()), phy_on=ps.phy_on,
        drift_on=ps.drift_on, reselect=ps.reselect, phy_link=ps.phy_link)


def port_continue(pss, sts, t0: int, t1: int) -> list:
    """Carry JAX-packed points and their states at cycle ``t0`` into the
    port, step them as lanes of one batch to ``t1``; numpy states."""
    import torch

    from repro_torch import carry
    from repro_torch.core import simulator as tsim
    ss = [carry.static_from_numpy(np_tree(ps.ss), "cpu") for ps in pss]
    st = [carry.state_from_numpy(np_tree(s), "cpu") for s in sts]
    ss = tsim.SimStatic(*(torch.stack(x) for x in zip(*ss)))
    st = tsim.SimState(*(torch.stack(x) for x in zip(*st)))
    ps0 = pss[0]
    out = np_tree(tsim.run_cycles(ss, st, t0, t1, ps0.B, ps0.mem_on,
                                  ps0.phy_on, ps0.drift_on, ps0.reselect))
    return [{k: v[g] for k, v in out.items()} for g in range(len(pss))]


# ---- MoE dispatch: which assignments each layer call keeps and drops


def _queues(experts: np.ndarray, n_experts: int) -> list:
    """Each expert's queue: the tokens that chose it, in token order (the
    order of a stable sort of the flat assignments by expert)."""
    return [np.nonzero((experts == e).any(-1))[0] for e in range(n_experts)]


@contextlib.contextmanager
def jax_moe_probe():
    """Record every call of the reference's ``moe_ff`` made inside the
    block (run eagerly or under ``jax.disable_jit()``): the router's
    probabilities [T, E] (f32), its top-k experts [T, k] and the (token,
    expert) assignments it dropped, sorted (with G dispatch groups, token
    ``t`` of group ``g`` counts as ``g * Tg + t``).  The
    calls are observed, not re-implemented: ``jax.lax.top_k`` and the
    module's ``constrain`` are wrapped, the token view and the dispatch
    buffer are read from ``constrain``'s arguments, and every expert's
    buffer rows are checked to hold its first ``cap`` tokens (the rest of
    the buffer zero) before its later tokens are counted as dropped."""
    import types

    import jax

    from repro.models import moe as jmoe

    calls, seen = [], []
    real_constrain, real_jax = jmoe.constrain, jmoe.jax

    def top_k(probs, k):
        vals, idx = jax.lax.top_k(probs, k)
        calls[-1]["probs"] = np.asarray(probs).reshape(-1, probs.shape[-1])
        calls[-1]["experts"] = np.asarray(idx).reshape(-1, k)
        return vals, idx

    def constrain(x, spec):
        n = len(seen)
        seen.append(None)
        if n % 4 == 0:                        # the token view [G, Tg, d]
            calls.append({"xf": np.asarray(x)})
        elif n % 4 == 1:                      # the buffer [G, E, cap, d]
            rec = calls[-1]
            G, Tg = rec["xf"].shape[:2]
            dropped = []
            for g, buf in enumerate(np.asarray(x)):
                E, cap = buf.shape[:2]
                xf = rec["xf"][g]
                queues = _queues(rec["experts"][g * Tg:(g + 1) * Tg], E)
                for e, q in enumerate(queues):
                    kept = min(cap, len(q))
                    want = np.zeros_like(buf[e])
                    want[:kept] = xf[q[:kept]]
                    assert np.array_equal(buf[e], want), \
                        f"group {g} expert {e}: the buffer is not its " \
                        f"first {cap} tokens"
                    dropped += [(int(t) + g * Tg, e) for t in q[cap:]]
            rec["dropped"] = sorted(dropped)
            rec["cap"] = int(cap)
            rec["groups"] = int(G)
            del rec["xf"]
        return real_constrain(x, spec)

    proxy = types.SimpleNamespace(
        lax=types.SimpleNamespace(top_k=top_k), nn=jax.nn, vmap=jax.vmap,
        ShapeDtypeStruct=jax.ShapeDtypeStruct)
    jmoe.constrain, jmoe.jax = constrain, proxy
    try:
        yield calls
    finally:
        jmoe.constrain, jmoe.jax = real_constrain, real_jax


@contextlib.contextmanager
def port_moe_probe():
    """The port's counterpart of ``jax_moe_probe``: ``moe.dispatch_plan``
    wrapped, each call's experts [T, k] (the groups' in turn), its number
    of groups and ``moe.dropped`` of its plan."""
    from repro_torch.models import moe

    calls = []
    real = moe.dispatch_plan

    def plan(experts, n_experts, cap):
        out = real(experts, n_experts, cap)
        calls.append({"experts": experts.reshape(
                          -1, experts.shape[-1]).cpu().numpy(),
                      "groups": experts.shape[0] if experts.ndim == 3 else 1,
                      "dropped": [tuple(r) for r in
                                  moe.dropped(out).cpu().tolist()],
                      "cap": cap})
        return out

    moe.dispatch_plan = plan
    try:
        yield calls
    finally:
        moe.dispatch_plan = real


# --------------------------------------------------------------------------
# training: one step of both packages from one carried (params, opt_state)

TRAIN_LOSS_RTOL = 5e-4     # Model.loss: flipped bf16 roundings, averaged
TRAIN_GNORM_RTOL = 1e-3    # the global norm of every gradient leaf
TRAIN_SHARE = 0.02         # entries whose update disagrees
TRAIN_ENTRY_REL = 0.1      # an entry agrees within 10% of its move ...
TRAIN_ENTRY_ULPS = 2.0 ** -7   # ... plus two bf16 ulps of its value
TRAIN_MOVE_RTOL = 1e-2     # per leaf mean |p - p0|
TRAIN_MOMENT_REL = 2.0 ** -5   # m, v: of each leaf's largest entry


def train_inputs(cfg, B: int, S: int, seed: int = 5) -> dict:
    """A numpy batch of ``B`` x ``S`` tokens and labels with the frontend
    stubs' embeddings of ``cfg``'s family (N(0, 1) f32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.audio_frames_default, cfg.d_model), dtype=np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm_patches_default, cfg.d_model), dtype=np.float32)
    return out


def mid_run_state(params_np: dict, seed: int = 6, step: int = 3):
    """A mid-run AdamW state for ``params_np`` (``{keystr: array}``): m
    ~ 1e-3 N(0, 1), v ~ 1e-5 |N(0, 1)|, as ``(step, m, v)`` dicts."""
    rng = np.random.default_rng(seed)
    m = {k: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32)
         for k, a in params_np.items()}
    v = {k: (np.abs(rng.standard_normal(a.shape)) * 1e-5).astype(np.float32)
         for k, a in params_np.items()}
    return step, m, v


def assert_step_close(p0: dict, got: dict, want: dict, got_m: dict,
                      want_m: dict, got_v: dict, want_v: dict) -> None:
    """One training step's parameters and moments (``{keystr: f32
    array}``) of the port against the reference's, leaf by leaf: for bf16
    leaves the share of entries whose value disagrees by more than 10% of
    its move plus two bf16 ulps (a gradient entry near zero, whose sign
    two summation orders may decide differently, moves the other way), for
    the f32 leaves each entry within 1e-2 of the leaf's largest move; the
    mean |p - p0|; the moments within 2^-5 of the leaf's largest entry."""
    from repro_torch.models.transformer import is_f32_leaf
    assert set(got) == set(want) == set(p0)
    for k in want:
        a, b, a0 = got[k], want[k], p0[k]
        moved = np.abs(b - a0)
        if is_f32_leaf(k):
            assert np.abs(a - b).max() <= 1e-2 * moved.max(), k
        else:
            bad = np.abs(a - b) > TRAIN_ENTRY_REL * moved \
                + TRAIN_ENTRY_ULPS * np.abs(b)
            share = float(np.mean(bad))
            assert share <= TRAIN_SHARE, (k, share)
        ma, mb = float(np.abs(a - a0).mean()), float(moved.mean())
        assert abs(ma - mb) <= TRAIN_MOVE_RTOL * mb + 1e-12, (k, ma, mb)
        for x, y, what in ((got_m[k], want_m[k], "m"),
                           (got_v[k], want_v[k], "v")):
            assert np.abs(x - y).max() <= TRAIN_MOMENT_REL \
                * np.abs(y).max(), (k, what)


def train_step_pair(name: str, *, B: int = 2, S: int = 16,
                    microbatches: int = 1, xent_chunk: int = 16) -> dict:
    """One ``make_train_step`` of the reference (op by op) and of the port
    (on the CPU) on ``name``'s smoke config, from one carried ``(params,
    opt_state)``: ``carry.numpy_params`` weights and a mid-run AdamW state
    (``mid_run_state``, carried with ``carry.opt_state_from_numpy``).
    Returns both metrics and ``{keystr: f32 array}`` trees."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.base import get_config as jconfig
    from repro.models.model import Model as JModel
    from repro.train import loop as jloop
    from repro.train import optimizer as jopt
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train import loop, optimizer

    cfg = get_config(name).smoke()
    npp = carry.numpy_params(cfg, 0)
    flat = dict(tf.leaves(npp))
    step, m, v = mid_run_state(flat)
    batch = train_inputs(cfg, B, S)
    jp = jax.tree_util.tree_map_with_path(
        lambda k, a: jnp.asarray(a, jnp.float32 if tf.is_f32_leaf(
            jax.tree_util.keystr(k)) else jnp.bfloat16), npp)
    jst = jopt.AdamWState(step=jnp.int32(step),
                          m=tf.unflatten((k, jnp.asarray(a))
                                         for k, a in m.items()),
                          v=tf.unflatten((k, jnp.asarray(a))
                                         for k, a in v.items()))
    sched = dict(peak=3e-3, warmup=5, total=20)
    jfn = jloop.make_train_step(
        JModel(jconfig(name).smoke(), xent_chunk=xent_chunk),
        jopt.AdamW(lr=jopt.cosine_schedule(**sched)),
        jloop.TrainConfig(microbatches=microbatches))
    with jax.disable_jit():
        jp2, jst2, jm = jfn(jp, jst, {k: jnp.asarray(a)
                                      for k, a in batch.items()})

    tp = carry.params_from_jax(npp, device="cpu")
    tst = carry.opt_state_from_numpy(step, tf.unflatten(m.items()),
                                     tf.unflatten(v.items()), device="cpu")
    tfn = loop.make_train_step(
        Model(cfg, xent_chunk=xent_chunk),
        optimizer.AdamW(lr=optimizer.cosine_schedule(**sched)),
        loop.TrainConfig(microbatches=microbatches))
    tp2, tst2, tm = tfn(tp, tst, {k: torch.from_numpy(a)
                                  for k, a in batch.items()})

    def jflat(tree):
        return {jax.tree_util.keystr(k): np.asarray(a, np.float32)
                for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def tflat(tree):
        return {k: a.float().numpy() for k, a in tf.leaves(tree)}

    p0 = {k: np.asarray(jnp.asarray(a, jnp.float32 if tf.is_f32_leaf(k)
                                    else jnp.bfloat16), np.float32)
          for k, a in flat.items()}
    return dict(p0=p0, jax_metrics={k: float(x) for k, x in jm.items()},
                port_metrics={k: float(x) for k, x in tm.items()},
                jax_params=jflat(jp2), port_params=tflat(tp2),
                jax_m=jflat(jst2.m), port_m=tflat(tst2.m),
                jax_v=jflat(jst2.v), port_v=tflat(tst2.v),
                jax_step=int(jst2.step), port_step=tst2.step)


def assert_train_pair_close(r: dict) -> None:
    """``train_step_pair``'s two steps agree: ``loss`` (rel 5e-4),
    ``gnorm`` (rel 1e-3), ``lr`` (rel 1e-6), the step count, and every
    leaf (``assert_step_close``)."""
    jm, tm = r["jax_metrics"], r["port_metrics"]
    for k, rtol in (("loss", TRAIN_LOSS_RTOL), ("gnorm", TRAIN_GNORM_RTOL),
                    ("lr", REL)):
        assert abs(tm[k] - jm[k]) <= rtol * abs(jm[k]), (k, tm[k], jm[k])
    assert r["port_step"] == r["jax_step"]
    assert_step_close(r["p0"], r["port_params"], r["jax_params"],
                      r["port_m"], r["jax_m"], r["port_v"], r["jax_v"])
