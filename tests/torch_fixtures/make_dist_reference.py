"""Write ``dist_reference.npz``: the JAX package's multi-device cases on
four host devices, for the port's distributed training path
(``tests/test_torch_sharding.py``, ``test_torch_grad_compress.py``,
``test_torch_pipeline.py``, the card's ``tests/test_torch_cuda.py``).

It records:

- ``compressed_psum`` over a (4,) "data" mesh inside ``shard_map``, for an
  f32 and a bf16 gradient with a carried f32 error: each device's inputs,
  int8 codes, scale and new residual, and the mean gradient;
- ``make_dp_train_step`` on a (4, 1) ("data", "model") mesh: 4 steps of
  granite-8b ``.smoke()`` (``SyntheticLM`` batches 0-3 of 4 x 32,
  ``xent_chunk=16``, ``AdamW(lr=1e-3)``), per step loss, gnorm and lr, and
  per leaf the mean |p - p0|, mean |m|, mean v and mean |err| after the
  last step;
- ``make_pp_loss`` loss and gradients (``jax.value_and_grad``, compiled,
  as ``tests/test_pipeline.py``): granite-8b ``.smoke()`` on (1, 2), 2
  stages, 2 microbatches, ``remat="none"``; hymba-1.5b ``.smoke()`` cut to
  4 layers on (1, 4), 4 stages, 4 microbatches, ``remat="full"``; batch
  4 x 32 drawn from ``PP_SEED``;
- ``moe_ff`` with ``specs=(None, None, G)``, G = 2 and 4, on the
  mixtral-8x22b and dbrx-132b ``.smoke()`` configs in bf16 (the input and
  weights of ``tests/test_torch_moe.py::_layer``, seed 6): the output;
- ``NamedSharding(mesh, spec).devices_indices_map`` of every leaf of the
  hymba-1.5b and mixtral-8x22b ``.smoke()`` params, train batch (4 x 32)
  and decode cache (4 x 32) on a (2, 2) ("data", "model") and a (2, 2, 1)
  ("pod", "data", "model") mesh, with the specs and the device order
  ``jax.make_mesh`` chose.

Every parameter tree is ``carry.numpy_params(cfg, seed=0)``, shared by
both packages.  Arrays are stored under ``/``-joined keys; bf16 values as
their f32 widening; the rest of the record is the JSON string ``meta``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_dist_reference.py

Takes ~1 minute (it sets ``XLA_FLAGS`` for 4 host devices itself, before
JAX is imported).
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import json  # noqa: E402
import pathlib  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs.base import ShapeSpec, get_config  # noqa: E402
from repro.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model  # noqa: E402
from repro.sharding import specs as sh  # noqa: E402
from repro.train import grad_compress as gc  # noqa: E402
from repro.train.optimizer import AdamW  # noqa: E402
from repro.train.pipeline import make_pp_loss  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.configs.base import get_config as port_config  # noqa: E402
from repro_torch.models import moe as port_moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

OUT = pathlib.Path(__file__).parent / "dist_reference.npz"
PSUM_SEED, PSUM_N = 11, 1000
DP_STEPS, DP_BATCH, DP_SEQ, DP_LR = 4, 4, 32, 1e-3
PP_SEED, PP_BATCH, PP_SEQ = 3, 4, 32
PP_CASES = {   # name: (arch, layers, mesh shape, stages, micro, remat)
    "granite": ("granite-8b", 2, (1, 2), 2, 2, "none"),
    "hybrid": ("hymba-1.5b", 4, (1, 4), 4, 4, "full"),
}
MOE_SEED, MOE_GROUPS = 6, (2, 4)
SPEC_ARCHS = ("hymba-1.5b", "mixtral-8x22b")
SPEC_MESHES = {"dm": ((2, 2), ("data", "model")),
               "pdm": ((2, 2, 1), ("pod", "data", "model"))}


def params_for(arch: str, layers=None):
    cfg = port_config(arch).smoke()
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    return carry.numpy_params(cfg, 0, leaf_fn=lambda name, a: jnp.asarray(
        a, jnp.float32 if tf.is_f32_leaf(name) else jnp.bfloat16))


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def spec_list(p: P) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in tuple(p)]


def compressed_psum_case(arrays: dict, meta: dict) -> None:
    mesh = make_mesh((4,), ("data",))
    rng = np.random.default_rng(PSUM_SEED)
    cc = gc.CompressionConfig()
    meta["psum"] = {}
    for dt in ("float32", "bfloat16"):
        scale = np.float32(2.0) ** rng.integers(-8, 4, (4, 1))
        g = (rng.standard_normal((4, PSUM_N)) * scale).astype(np.float32)
        err = (rng.standard_normal((4, PSUM_N)) * scale * 1e-2).astype(
            np.float32)
        gj = jnp.asarray(g, getattr(jnp, dt))

        def body(g, e):
            mean, new_err = gc.compressed_psum(g[0], e[0], "data", cc)
            q, s = gc.quantize(g[0].astype(jnp.float32) + e[0], cc.bits)
            return mean[None], new_err[None], q[None], s[None]

        fn = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P("data"), P("data")),
            out_specs=(P("data"), P("data"), P("data"), P("data")),
            check_vma=False))
        mean, new_err, q, s = fn(gj, jnp.asarray(err))
        pre = f"psum/{dt}/"
        arrays[pre + "g"] = f32(gj)
        arrays[pre + "err"] = err
        arrays[pre + "mean"] = f32(mean)
        arrays[pre + "new_err"] = np.asarray(new_err)
        arrays[pre + "codes"] = np.asarray(q)
        arrays[pre + "scale"] = np.asarray(s)
        meta["psum"][dt] = {"n": PSUM_N}


def dp_case(arrays: dict, meta: dict) -> None:
    cfg = get_config("granite-8b").smoke()
    mesh = make_mesh((4, 1), ("data", "model"))
    params = params_for("granite-8b")
    p0 = {k: f32(v) for k, v in flat(params).items()}
    model = Model(cfg, xent_chunk=16)
    opt = AdamW(lr=DP_LR)
    state = opt.init(params)
    err = gc.init_error(params)
    step = gc.make_dp_train_step(model, opt, mesh, gc.CompressionConfig())
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=DP_SEQ,
                                  global_batch=DP_BATCH))
    steps = []
    for i in range(DP_STEPS):
        b = {k: jnp.asarray(v) for k, v in data.batch(i).items()}
        params, state, err, m = step(params, state, err, b)
        steps.append({k: float(v) for k, v in m.items()})
    fm, fv, fe = flat(state.m), flat(state.v), flat(err)
    leaves = {}
    for k, v in flat(params).items():
        leaves[k] = {"mean_abs_delta": float(np.abs(f32(v) - p0[k]).mean()),
                     "m_mean_abs": float(np.abs(f32(fm[k])).mean()),
                     "v_mean": float(f32(fv[k]).mean()),
                     "err_mean_abs": float(np.abs(f32(fe[k])).mean())}
    meta["dp"] = {"arch": "granite-8b", "mesh": [4, 1], "steps": DP_STEPS,
                  "batch": DP_BATCH, "seq": DP_SEQ, "lr": DP_LR,
                  "xent_chunk": 16, "metrics": steps, "leaves": leaves}


def pp_case(arrays: dict, meta: dict) -> None:
    meta["pp"] = {}
    rng = np.random.default_rng(PP_SEED)
    for name, (arch, layers, shape, S, M, remat) in PP_CASES.items():
        cfg = get_config(arch).smoke().scaled(n_layers=layers)
        mesh = make_mesh(shape, ("data", "model"))
        params = params_for(arch, layers)
        toks = rng.integers(0, cfg.vocab, (PP_BATCH, PP_SEQ)).astype(np.int32)
        labs = rng.integers(0, cfg.vocab, (PP_BATCH, PP_SEQ)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
        pp = make_pp_loss(cfg, mesh, n_stages=S, n_micro=M, remat=remat,
                          xent_chunk=16)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(pp))(params, batch)
        pre = f"pp/{name}/"
        arrays[pre + "tokens"] = toks
        arrays[pre + "labels"] = labs
        for k, g in flat(grads).items():
            arrays[pre + "grad" + k] = f32(g)
        meta["pp"][name] = {"arch": arch, "layers": layers,
                            "mesh": list(shape), "stages": S, "micro": M,
                            "remat": remat, "loss": float(loss)}


def moe_case(arrays: dict, meta: dict) -> None:
    meta["moe"] = {}
    for arch in ("mixtral-8x22b", "dbrx-132b"):
        jcfg, cfg = get_config(arch).smoke(), port_config(arch).smoke()
        rng = np.random.default_rng(MOE_SEED)
        p = {k: rng.standard_normal(s).astype(np.float32) * s[-2] ** -0.5
             for k, s in port_moe.moe_shapes(cfg).items()}
        x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
        x += np.float32(2.0) * rng.standard_normal(cfg.d_model).astype(
            np.float32)
        for G in MOE_GROUPS:
            y = jmoe.moe_ff(jnp.asarray(x, jnp.bfloat16),
                            {k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in p.items()}, jcfg,
                            specs=(None, None, G))
            arrays[f"moe/{arch}/{G}/y"] = f32(y)
        meta["moe"][arch] = {"seed": MOE_SEED, "tokens": [2, 64],
                             "skew": 2.0, "groups": list(MOE_GROUPS)}


def index_map(tree_specs, mesh, shapes: dict, out: dict) -> None:
    for path, spec in flat(tree_specs).items():
        shape = shapes[path]
        imap = NamedSharding(mesh, spec).devices_indices_map(shape)
        out[path] = {
            "shape": list(shape), "spec": spec_list(spec),
            "index": {str(d.id): [[sl.start or 0, dim if sl.stop is None
                                   else sl.stop]
                                  for sl, dim in zip(idx, shape)]
                      for d, idx in imap.items()}}


def spec_case(arrays: dict, meta: dict) -> None:
    meta["specs"] = {}
    for mname, (shape, axes) in SPEC_MESHES.items():
        mesh = make_mesh(shape, axes)
        rec = {"axes": list(axes), "shape": list(shape),
               "devices": np.vectorize(lambda d: d.id)(
                   mesh.devices).tolist(), "archs": {}}
        for arch in SPEC_ARCHS:
            cfg = get_config(arch).smoke()
            model = Model(cfg)
            pspec = model.param_specs()
            inputs = model.input_specs(ShapeSpec("t", PP_SEQ, 4, "train"))
            cache = model.decode_state_specs(4, PP_SEQ)
            trees = {
                "params": (sh.param_pspecs(cfg, pspec, mesh), pspec),
                "batch": (sh.batch_pspecs(inputs, mesh), inputs),
                "cache": (sh.cache_pspecs(cfg, cache, mesh), cache)}
            arec = {}
            for tname, (specs, abstract) in trees.items():
                shapes = {k: tuple(v.shape) for k, v in flat(abstract).items()}
                arec[tname] = {}
                index_map(specs, mesh, shapes, arec[tname])
            rec["archs"][arch] = arec
        meta["specs"][mname] = rec


def main() -> None:
    t0 = time.perf_counter()
    assert len(jax.devices()) >= 4, jax.devices()
    arrays, meta = {}, {"jax": jax.__version__}
    for case in (compressed_psum_case, spec_case, moe_case, pp_case,
                 dp_case):
        case(arrays, meta)
        print(f"{case.__name__} done ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    arrays["meta"] = np.array(json.dumps(meta))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, "
          f"{time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
