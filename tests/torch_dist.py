"""Gloo ranks on the CPU for the port's distributed tests.

``run(name, world, tmp_path, **kw)`` spawns ``world`` processes, joins
them into a gloo process group through a ``file://`` rendezvous under
``tmp_path`` (no fixed port: several test files may run at once), calls
the worker ``name`` of this module on every rank and returns each rank's
result (a dict).  The workers import torch and the port only, and read the
JAX package's results from ``torch_fixtures/dist_reference.npz``
(``make_dist_reference.py``).

``python tests/torch_dist.py production_specs OUT.json`` writes the
port's spec trees on the two production meshes, under a fake process
group of 512 ranks, for every registered config; ``python
tests/torch_dist.py dryrun OUT.json PART`` one part of the port's dry
run (``launch/dryrun.py``) there.
"""
from __future__ import annotations

import json
import math
import pathlib
import sys

import numpy as np
import torch

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / \
    "dist_reference.npz"
PP_DTENSOR_FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / \
    "pp_dtensor_reference.npz"
TIMEOUT_S = 120          # a rank waiting longer on a collective fails


def fixture() -> tuple:
    z = np.load(FIXTURE)
    return z, json.loads(str(z["meta"]))


def _entry(rank, world, rdv, out, name, kw):
    torch.set_num_threads(1)
    from repro_torch.launch import mesh
    mesh.init_distributed(rank, world, rdv, device="cpu",
                          timeout_s=TIMEOUT_S)
    try:
        res = globals()[name](rank, **kw)
        torch.save(res, pathlib.Path(out) / f"rank{rank}.pt")
    finally:
        mesh.shutdown()


def run(name: str, world: int, tmp_path, **kw) -> list:
    import torch.multiprocessing as mp
    out = pathlib.Path(tmp_path) / name
    out.mkdir(parents=True, exist_ok=True)
    rdv = f"file://{out / 'rendezvous'}"
    mp.start_processes(_entry, args=(world, rdv, str(out), name, kw),
                       nprocs=world, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def spec_list(p) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in tuple(p)]


def port_trees(arch: str, mesh) -> dict:
    """The port's spec trees of ``arch``'s smoke config on ``mesh``:
    params, a train batch of 4 x 32, a decode cache of 4 x 32."""
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.models.model import Model
    from repro_torch.sharding import specs as sh
    cfg = get_config(arch).smoke()
    model = Model(cfg)
    pspec = model.param_specs()
    inputs = sh.meta(model.input_specs(ShapeSpec("t", 32, 4, "train")))
    cache = model.decode_state_specs(4, 32)
    return {"params": sh.param_pspecs(cfg, pspec, mesh),
            "batch": sh.batch_pspecs(inputs, mesh),
            "cache": sh.cache_pspecs(cfg, cache, mesh)}


# ---- workers -------------------------------------------------------------

def _shard_mismatches(mesh, rec: dict, archs, only=None) -> tuple:
    """Each leaf's local shard on this rank against the fixture's index
    map for the device of the same number (rank r against JAX's device
    r): (spec mismatches, shard mismatches, leaves checked)."""
    import torch.distributed as dist

    from repro_torch.models import transformer as tf
    from repro_torch.sharding import specs as sh
    dev_id = str(dist.get_rank())
    bad_spec, bad_shard, n = [], [], 0
    for arch in archs:
        for tname, specs in port_trees(arch, mesh).items():
            want = rec["archs"][arch][tname]
            for path, spec in tf.leaves(specs):
                w = want[path]
                if only is not None and not only(w["spec"]):
                    continue
                n += 1
                if spec_list(spec) != w["spec"]:
                    bad_spec.append((arch, tname, path))
                shape = tuple(w["shape"])
                g = torch.arange(math.prod(shape),
                                 dtype=torch.float64).reshape(shape)
                local = sh.distribute(g, spec, mesh).to_local()
                block = g[tuple(slice(a, b) for a, b in w["index"][dev_id])]
                if not torch.equal(local, block):
                    bad_shard.append((arch, tname, path))
    return bad_spec, bad_shard, n


def sharding(rank: int, ckpt_dir: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import carry
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.interconnect import scheduler
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import specs as sh
    z, meta = fixture()
    out = {}
    archs = tuple(meta["specs"]["dm"]["archs"])
    for mname, rec in meta["specs"].items():
        mesh = M.make_mesh(rec["shape"], rec["axes"], device="cpu")
        out[f"layout/{mname}"] = mesh.mesh.tolist() == rec["devices"]
        out[f"shards/{mname}"] = _shard_mismatches(mesh, rec, archs)
    # a planted fault: pod and data swapped in the rank layout, so that a
    # dim split over ("pod", "data") is laid out data-major
    rec = meta["specs"]["pdm"]
    swapped = DeviceMesh("cpu", torch.arange(4).reshape(2, 2, 1)
                         .transpose(0, 1), mesh_dim_names=tuple(rec["axes"]))
    out["shards/pdm swapped"] = _shard_mismatches(
        swapped, rec, archs, only=lambda s: ["pod", "data"] in s)

    # constrain: a redistribute on DTensors, identity on plain tensors
    dm = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.arange(32.0).reshape(4, 8)
    d = sh.distribute(x, sh.P("data", None), dm)
    c = sh.constrain(d, sh.P(None, "model"))
    out["constrain"] = {
        "placements": [str(p) for p in c.placements],
        "want": [str(p) for p in (Replicate(), Shard(1))],
        "local": c.to_local().clone(),
        "full_equal": torch.equal(c.full_tensor(), x),
        "none_is_identity": sh.constrain(d, None) is d,
        "plain_is_identity": sh.constrain(x, sh.P("data")) is x,
        "is_dtensor": isinstance(c, DTensor)}

    # elastic restore: a checkpoint written by rank 0 from plain tensors,
    # restored onto the 2 x 2 mesh by the params' specs, then gathered
    cfg = get_config("hymba-1.5b").smoke()
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device="cpu")
    cm = CheckpointManager(ckpt_dir, async_save=False)
    if rank == 0:
        cm.save(7, params, blocking=True)
    dist.barrier()
    pspecs = sh.param_pspecs(cfg, tf.param_specs(cfg), dm)
    restored = cm.restore(7, params, shardings=sh.named(pspecs, dm))
    bad_gather, bad_local, sharded = [], [], 0
    for (path, p), (_, r), (_, spec) in zip(
            tf.leaves(params), tf.leaves(restored), tf.leaves(pspecs)):
        if not isinstance(r, DTensor):
            bad_gather.append(path)
            continue
        sharded += any(a is not None for a in spec)
        if not torch.equal(r.full_tensor(), p):
            bad_gather.append(path)
        if not torch.equal(r.to_local(), sh.distribute(p, spec,
                                                       dm).to_local()):
            bad_local.append(path)
    out["restore"] = {"bad_gather": bad_gather, "bad_local": bad_local,
                      "sharded_leaves": sharded,
                      "leaves": len(list(tf.leaves(params)))}

    # the two-level all-reduce against one flat all-reduce
    pdm = M.make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    vals = [torch.from_numpy(np.random.default_rng([5, r]).integers(
        -1000, 1000, (3, 5)).astype(np.float32)) for r in range(4)]
    flat = vals[rank].clone()
    dist.all_reduce(flat)
    tree = {"a": vals[rank], "b": {"c": vals[rank] * 0.5}}
    hier = scheduler.hierarchical_grad_reduce(tree, mesh=pdm)
    out["hier"] = {
        "equal_flat": torch.equal(scheduler.hierarchical_psum(
            vals[rank], "data", "pod", mesh=pdm), flat),
        "equal_sum": torch.equal(flat, sum(vals)),
        "tree_equal": torch.equal(hier["a"], flat)
        and torch.equal(hier["b"]["c"], flat * 0.5),
        "input_kept": torch.equal(tree["a"], vals[rank])}

    # meshes need enough ranks
    errors = {}
    for nm, fn in (("production", lambda: M.make_production_mesh(
            device="cpu")), ("multi_pod", lambda: M.make_production_mesh(
                multi_pod=True, device="cpu"))):
        try:
            fn()
        except ValueError as e:
            errors[nm] = str(e)
    out["mesh_errors"] = errors
    out["host_mesh"] = M.axis_sizes(M.make_host_mesh(device="cpu"))
    return out


def compress(rank: int, fault: str = "") -> dict:
    """``compressed_psum`` on a (4,) "data" mesh for the fixture's f32 and
    bf16 gradients, and ``make_dp_train_step`` on a (4, 1) mesh for the
    fixture's four steps.  ``fault="no_error_feedback"`` runs both with the
    error feedback off."""
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.optimizer import AdamW
    z, meta = fixture()
    cc = gc.CompressionConfig(error_feedback=fault != "no_error_feedback")
    out = {"psum": {}}
    m4 = M.make_mesh((4,), ("data",), device="cpu")
    for dt in meta["psum"]:
        pre = f"psum/{dt}/"
        g = torch.from_numpy(z[pre + "g"][rank]).to(getattr(torch, dt))
        err = torch.from_numpy(z[pre + "err"][rank])
        mean, new_err = gc.compressed_psum(g, err, m4, ("data",), cc)
        q, s = gc.quantize(g.float() + err, cc.bits)
        want_mean = z[pre + "mean"][rank]
        # one unit in the last place of the mean's dtype (bf16 keeps 16
        # fewer bits of the significand than f32)
        ulp = np.spacing(np.abs(want_mean)) * (2.0 ** 16 if dt == "bfloat16"
                                               else 1.0)
        ulps = np.abs(mean.float().numpy() - want_mean) / ulp
        out["psum"][dt] = {
            "codes_equal": bool(np.array_equal(q.numpy(),
                                               z[pre + "codes"][rank])),
            "scale_equal": bool(s.item() == float(z[pre + "scale"][rank])),
            "err_equal": bool(np.array_equal(new_err.numpy(),
                                             z[pre + "new_err"][rank])),
            "mean_dtype": str(mean.dtype),
            "mean_max_ulps": float(ulps.max()),
            "mean_equal": bool(np.array_equal(mean.float().numpy(),
                                              want_mean))}

    dp = meta["dp"]
    cfg = get_config(dp["arch"]).smoke()
    mesh = M.make_mesh(tuple(dp["mesh"]), ("data", "model"), device="cpu")
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device="cpu")
    p0 = {k: v.float().clone() for k, v in tf.leaves(params)}
    opt = AdamW(lr=dp["lr"])
    state = opt.init(params)
    err = gc.init_error(params)
    step = gc.make_dp_train_step(Model(cfg, xent_chunk=dp["xent_chunk"]),
                                 opt, mesh, cc, device="cpu")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=dp["seq"],
                                  global_batch=dp["batch"]))
    steps = []
    for i in range(dp["steps"]):
        b = {k: torch.from_numpy(v) for k, v in data.batch(i).items()}
        params, state, err, m = step(params, state, err, b)
        steps.append({k: float(v) for k, v in m.items()})
    leaves = {}
    for (k, p), (_, mm), (_, v), (_, e) in zip(
            tf.leaves(params), tf.leaves(state.m), tf.leaves(state.v),
            tf.leaves(err)):
        leaves[k] = {"mean_abs_delta": float((p.float() - p0[k]).abs()
                                             .mean()),
                     "m_mean_abs": float(mm.abs().mean()),
                     "v_mean": float(v.mean()),
                     "err_mean_abs": float(e.abs().mean())}
    out["dp"] = {"metrics": steps, "leaves": leaves,
                 "params": {k: v.float() for k, v in tf.leaves(params)}}
    return out


def pipeline(rank: int, fault: str = "") -> dict:
    """The fixture's two pipeline cases: granite-8b smoke, 2 stages on a
    (2, 2) ("data", "model") mesh (two pipelines side by side), and the
    4-layer hymba-1.5b smoke cut, 4 stages on (1, 4); each rank's loss and
    gradients, with the port's sequential ``Model.loss`` beside them.
    ``fault="handoff_backward"`` drops the hand-off's backward (it returns
    zeros and sends nothing)."""
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.train import pipeline as pp
    from repro_torch.train.loop import value_and_grad
    z, meta = fixture()
    if fault == "handoff_backward":
        pp._Tick.backward = staticmethod(
            lambda ctx, g_handed, g_y: (g_y, None, None, None))
    shapes = {"granite": (2, 2), "hybrid": (1, 4)}
    out = {}
    for name, c in meta["pp"].items():
        cfg = get_config(c["arch"]).smoke().scaled(n_layers=c["layers"])
        mesh = M.make_mesh(shapes[name], ("data", "model"), device="cpu")
        params = carry.params_from_jax(carry.numpy_params(cfg, 0),
                                       device="cpu")
        pre = f"pp/{name}/"
        batch = {"tokens": torch.from_numpy(z[pre + "tokens"]),
                 "labels": torch.from_numpy(z[pre + "labels"])}
        loss_fn = pp.make_pp_loss(cfg, mesh, n_stages=c["stages"],
                                  n_micro=c["micro"], remat=c["remat"],
                                  xent_chunk=16, device="cpu")
        loss, grads = value_and_grad(loss_fn, params, batch)
        rec = {"loss": float(loss),
               "grads": {k: g.float() for (k, _), g in
                         zip(tf.leaves(params), grads)}}
        if rank == 0:
            sl, sg = value_and_grad(Model(cfg, xent_chunk=16).loss, params,
                                    batch)
            rec["seq_loss"] = float(sl)
            rec["seq_grads"] = {k: g.float() for (k, _), g in
                                zip(tf.leaves(params), sg)}
        out[name] = rec
    return out


def pipeline_dtensor(rank: int, fault: str = "") -> dict:
    """The pipeline on DTensors, as the dry run places it, with real
    values on a (2, 2) ("data", "model") mesh: for granite-8b's and
    hymba-1.5b's smoke configs (2 layers: 2 stages of 1, 2 microbatches,
    weights ``carry.numpy_params(cfg, 0)``, the 4 x 32 batch of
    ``pp_dtensor_reference.npz``), the parameters and batch placed by
    ``dryrun.build_step``'s ``--pp`` specs, ``make_pp_loss``'s loss and
    every gradient gathered, the plain one-device ``Model.loss``'s beside
    them, and the step's collective sequence
    (``graph_traffic.step_collectives``) as (op, payload, group size,
    stride).  ``hybrid_layer_f32``: hymba-1.5b's smoke layer in f32 on a
    [2, 32, d] x split on its width over "data" (a stage's layout), its
    loss and gradients beside the plain layer's.
    ``fault="handoff_backward"``: the hand-off's backward sends nothing
    back (zeros)."""
    from repro_torch import carry
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.interconnect import graph_traffic as gt
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.sharding import specs as sh
    from repro_torch.train import pipeline as pp
    from repro_torch.train.loop import value_and_grad
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    if fault == "handoff_backward":
        pp._Tick.backward = staticmethod(
            lambda ctx, g_handed, g_y: (g_y, None, None, None))
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    z = np.load(PP_DTENSOR_FIXTURE)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    out = {"hybrid_layer_f32": _width_split_layer(mesh["data"])}
    for arch in ("granite-8b", "hymba-1.5b"):
        cfg = get_config(arch).smoke()
        shape = ShapeSpec("t", 32, 4, "train")
        _, args, specs = D.build_step(cfg, shape, mesh, device="cpu", pp=2,
                                      remat="none")
        params = carry.params_from_jax(carry.numpy_params(cfg, 0),
                                       device="cpu")
        batch = {k: torch.from_numpy(z[f"{arch}/{k}"])
                 for k in ("tokens", "labels")}
        dparams = sh.distribute(params, specs[0], mesh)
        dbatch = sh.distribute(batch, specs[2], mesh)
        loss_fn = pp.make_pp_loss(cfg, mesh, n_stages=2, n_micro=2,
                                  remat="none", xent_chunk=16, device="cpu")
        with implicit_replication():
            sl, sg = value_and_grad(Model(cfg, xent_chunk=16).loss, params,
                                    batch)
            calls = gt.step_collectives(value_and_grad, loss_fn, dparams,
                                        dbatch)
            loss, grads = value_and_grad(loss_fn, dparams, dbatch)
            out[arch] = {
                "loss": (float(sl), float(full(loss))),
                "grads": {k: (a.float(), full(b).float()) for (k, _), a, b
                          in zip(tf.leaves(params), sg, grads)},
                "calls": [(c.op, c.payload_bytes, c.group_size, c.stride)
                          for c in calls]}
    return out


def _width_split_layer(sub) -> dict:
    """One hybrid layer (hymba-1.5b smoke, f32 weights) on an x split on
    its width over the 1-D mesh ``sub`` (the layout of a pipeline stage),
    the weights split on their first dim where it divides: the summed
    squares of its output and their gradients, beside the plain
    layer's."""
    from repro_torch import carry
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.sharding import specs as sh
    from repro_torch.train.loop import value_and_grad
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config("hymba-1.5b").smoke()
    lp = sh.tree_map(lambda t: t.float(), tf.layer_params(
        carry.params_from_jax(carry.numpy_params(cfg, 0),
                              device="cpu")["layers"], 0))
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    pos = torch.arange(32)

    def f(p, b):
        y = tf._layer_body(cfg, b["x"], p, positions=pos, causal=True,
                           impl="blockwise")
        return (y.float() ** 2).sum()

    dlp = sh.tree_map(lambda t: distribute_tensor(
        t, sub, [Shard(0)] if t.ndim > 1 and t.shape[0] % sub.size() == 0
        else [Replicate()]), lp)
    dx = distribute_tensor(x, sub, [Shard(2)])
    l0, g0 = value_and_grad(f, lp, {"x": x})
    with implicit_replication():
        l1, g1 = value_and_grad(f, dlp, {"x": dx})
    full = (lambda t: t.full_tensor() if isinstance(t, DTensor) else t)
    return {"loss": (float(l0), float(full(l1))),
            "grads": {k: (a, full(b)) for (k, _), a, b in
                      zip(tf.leaves(lp), g0, g1)}}


def production_specs(path: str) -> None:
    """The port's spec trees for every registered config on the two
    production meshes (fake process group of 512 ranks), for each
    ``ShardingConfig`` variant of ``SC_VARIANTS``, as JSON."""
    from repro_torch.configs.base import SHAPES, all_configs
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.sharding import specs as sh
    M.init_fake(512)
    out = {}
    for multi in (False, True):
        mesh = M.make_production_mesh(multi_pod=multi, device="cpu")
        for arch, cfg in sorted(all_configs().items()):
            model = Model(cfg)
            pspec = model.param_specs()
            dec = SHAPES["decode_32k"]
            cache = model.decode_state_specs(dec.global_batch, dec.seq_len)
            for vname, kw in SC_VARIANTS.items():
                sc = sh.ShardingConfig(**kw)
                rec = {"params": sh.param_pspecs(cfg, pspec, mesh, sc),
                       "cache": sh.cache_pspecs(cfg, cache, mesh, sc)}
                for shp in ("train_4k", "decode_32k"):
                    rec[f"batch/{shp}"] = sh.batch_pspecs(
                        sh.meta(model.input_specs(SHAPES[shp])), mesh)
                out[f"{int(multi)}/{arch}/{vname}"] = {
                    t: {p: spec_list(s) for p, s in tf.leaves(tree)}
                    for t, tree in rec.items()}
    M.shutdown()
    pathlib.Path(path).write_text(json.dumps(out))


# the archs ``sharded_paths`` runs (smoke configs), and the sequence-
# parallel attention case (``sp``: q's sequence split as the dry run pins
# it where the heads do not divide the model axis)
SHARDED_ARCHS = ("granite-8b", "hymba-1.5b", "mixtral-8x22b", "mamba2-1.3b",
                 "whisper-tiny")


def sharded_paths(rank: int) -> dict:
    """The dry run's DTensor paths with real values on a (2, 2) ("data",
    "model") mesh: for each of ``SHARDED_ARCHS`` (smoke config, weights
    ``carry.numpy_params(cfg, 0)``), the parameters and a 4 x 32 batch
    placed by the spec trees and the model of ``dryrun.build_model``: the
    loss and every gradient (``value_and_grad``), the loss of a
    2-microbatch train step, and two decode steps (position a 0-d tensor;
    the cache split on its sequence, then on its head dim) gathered, with
    the plain one-device results beside them.  granite-8b also runs with
    ``sp_specs`` forced (q's sequence split)."""
    from repro_torch import carry
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as tf
    from repro_torch.models.model import Model
    from repro_torch.sharding import specs as sh
    from repro_torch.train.loop import (TrainConfig, make_train_step,
                                        value_and_grad)
    from repro_torch.train.optimizer import AdamW
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    out = {}
    cases = [(a, False) for a in SHARDED_ARCHS] + [("granite-8b", True)]
    for arch, force_sp in cases:
        cfg = get_config(arch).smoke()
        shape = ShapeSpec("t", 32, 4, "train")
        _, args, specs = D.build_step(cfg, shape, mesh, device="cpu",
                                      seq_shard_decode=True, remat="none")
        dmodel = D.build_model(cfg, mesh, remat="none")
        dmodel.xent_chunk = 16
        if force_sp:
            dmodel.sp_specs = (sh.P(("data",), "model", None, None),
                               sh.P(("data",), None, None, None))
        # the one-device port with the same dispatch groups
        model = Model(cfg, xent_chunk=16, moe_specs=None if
                      dmodel.moe_specs is None else
                      (None, None, dmodel.moe_specs[2]))
        params = carry.params_from_jax(carry.numpy_params(cfg, 0),
                                       device="cpu")
        g = torch.Generator().manual_seed(3)
        batch = model.make_inputs(shape, g)
        dparams = sh.distribute(params, specs[0], mesh)
        dbatch = sh.distribute(batch, specs[2], mesh)
        rec = {}
        with implicit_replication():
            loss, grads = value_and_grad(model.loss, params, batch)
            dloss, dgrads = value_and_grad(dmodel.loss, dparams, dbatch)
            rec["loss"] = (float(loss), float(full(dloss)))
            rec["grads"] = {k: (a.float(), full(b).float()) for (k, _), a, b
                            in zip(tf.leaves(params), grads, dgrads)}
            opt = AdamW(lr=1e-3)
            mb = make_train_step(model, opt, TrainConfig(microbatches=2))
            dmb = make_train_step(dmodel, opt, TrainConfig(microbatches=2),
                                  grad_pspecs=specs[0])
            p2 = {k: v.clone() for k, v in tf.leaves(params)}
            p2 = tf.unflatten(p2.items())
            dp2 = sh.distribute(p2, specs[0], mesh)
            _, _, m = mb(p2, opt.init(p2), batch)
            dst = sh.distribute(tf.unflatten(
                (k, torch.zeros_like(v, dtype=torch.float32))
                for k, v in tf.leaves(p2)), specs[0], mesh)
            from repro_torch.train.optimizer import AdamWState
            _, _, dm = dmb(dp2, AdamWState(0, dst, sh.tree_map(
                torch.zeros_like, dst)), dbatch)
            rec["micro_loss"] = (float(m["loss"]), float(full(dm["loss"])))
            rec["micro_gnorm"] = (float(m["gnorm"]), float(full(dm["gnorm"])))
            for seq in (True, False) if cfg.family != "encdec" else ():
                cache = model.init_decode_state(4, 32, device="cpu")
                cspec = sh.cache_pspecs(cfg, tf.decode_state_specs(
                    cfg, 4, 32), mesh, sh.ShardingConfig(
                        seq_shard_decode=seq))
                dcache = sh.distribute(cache, cspec, mesh)
                toks = batch["tokens"][:, :1]
                dtoks = sh.distribute({"t": toks}, sh.batch_pspecs(
                    {"t": toks}, mesh), mesh)["t"]
                logits = []
                for t in range(2):
                    lg, cache = model.decode(params, cache, toks, t)
                    pos = sh.distribute({"p": torch.tensor(
                        t, dtype=torch.int32)}, {"p": sh.P()}, mesh)["p"]
                    dlg, dcache = dmodel.decode(dparams, dcache, dtoks, pos)
                    logits.append((lg.float(), full(dlg).float()))
                tag = "" if seq else "/hd"
                rec["decode_logits" + tag] = logits
                rec["decode_cache" + tag] = {k: (cache[k].float(),
                                                 full(dcache[k]).float())
                                             for k in cache}
        out[f"{arch}{'/sp' if force_sp else ''}"] = rec
    return out


def sharded_ops(rank: int, fault: str = "") -> dict:
    """Each DTensor path of the dry run against its plain version in f32
    on a (2, 2) ("data", "model") mesh, inputs drawn from one seed on every
    rank and placed as the models place them: the result and every
    input's gradient (of a fixed random weighting of the result),
    gathered, as (plain, sharded) pairs.  ``fault="replicated_kv_grads"``
    drops every ``to_local(grad_placements=)``: a rank's partial gradient
    is then taken for the whole one."""
    from torch.distributed.tensor import DTensor as _DT
    if fault == "replicated_kv_grads":
        to_local = _DT.to_local
        _DT.to_local = lambda self, *, grad_placements=None: to_local(self)
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.models import attention as attn
    from repro_torch.models import moe, ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import dot
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.specs import P
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def check(fn, inputs, specs, grads=True):
        plain = [t.clone().requires_grad_(grads and t.is_floating_point())
                 for t in inputs]
        dist_ = [sh.distribute(t, s, mesh).detach().requires_grad_(
            grads and t.is_floating_point()) if s is not None else t
            for t, s in zip(inputs, specs)]
        with implicit_replication():
            y, yd = fn(*plain), fn(*dist_)
            w = rnd(*y.shape)
            rec = {"out": (y.detach(), full(yd).detach())}
            if grads:
                (y * w).sum().backward()
                (yd * sh.distribute(w, P(), mesh)).sum().backward()
                for i, (a, b) in enumerate(zip(plain, dist_)):
                    if a.grad is not None:
                        rec[f"grad{i}"] = (a.grad, full(b.grad))
        return rec

    out = {}
    out["dot/fsdp+tp"] = check(dot, [rnd(4, 8, 16), rnd(16, 12)],
                               [P("data", None, None), P("data", "model")])
    out["dot/row"] = check(dot, [rnd(4, 8, 16), rnd(16, 12)],
                           [P("data", None, "model"), P("model", "data")])
    out["dot/experts"] = check(dot, [rnd(4, 6, 16), rnd(4, 16, 12)],
                               [P(None, "data", None),
                                P("model", "data", None)])
    for name, (qs, ks, causal, window) in {
            "heads": (P("data", None, "model", None),
                      P("data", None, "model", None), True, 0),
            "seq": (P("data", "model", None, None), P("data", None, None,
                                                      None), True, 5),
            "seq/bidirectional": (P("data", "model", None, None),
                                  P("data", None, None, None), False, 0)
    }.items():
        out[f"attention/{name}"] = check(
            lambda q, k, v: (attn.inner_on_shards if isinstance(q, DTensor)
                             else attn.attention_inner)(
                q, k, v, causal=causal, window=window, impl="blockwise"),
            [rnd(4, 16, 4, 8), rnd(4, 16, 2, 8), rnd(4, 16, 2, 8)],
            [qs, ks, ks])
    A = -torch.rand(4, generator=gen) - 0.5
    out["ssd"] = check(
        lambda x, dt, a, b, c: (ssm.ssd_on_shards if isinstance(x, DTensor)
                                else ssm.ssd_chunked)(x, dt, a, b, c, 8,
                                                      impl="blockwise")[0],
        [rnd(4, 32, 4, 8), torch.rand(4, 32, 4, generator=gen) * 0.1, A,
         rnd(4, 32, 8), rnd(4, 32, 8)],
        [P("data", None, "model", None), P("data", None, None), P(),
         P("data", None, None), P("data", None, None)])
    out["ssd/state"] = check(
        lambda x, dt, a, b, c: (ssm.ssd_on_shards if isinstance(x, DTensor)
                                else ssm.ssd_chunked)(x, dt, a, b, c, 8,
                                                      impl="blockwise")[1],
        [rnd(4, 32, 4, 8), torch.rand(4, 32, 4, generator=gen) * 0.1, A,
         rnd(4, 32, 8), rnd(4, 32, 8)],
        [P("data", None, "model", None), P("data", None, None), P(),
         P("data", None, None), P("data", None, None)])
    out["ssd/decode"] = check(
        lambda s, dt, a, b, x, c: (ssm.recur_on_shards if isinstance(
            s, DTensor) else ssm.recur)(s, dt, a, b, x, c)[0],
        [rnd(4, 4, 8, 8), torch.rand(4, 4, generator=gen) * 0.1, A,
         rnd(4, 8), rnd(4, 4, 8), rnd(4, 8)],
        [P("data", "model", None, None), P("data", None), P(),
         P("data", None), P("data", None, None), P("data", None)],
        grads=False)
    toks = torch.randint(-3, 70, (4, 8), generator=gen)
    out["embed"] = check(tf.embed, [rnd(64, 16), toks],
                         [P("model", "data"), P("data", None)])
    cfg = get_config("mixtral-8x22b").smoke()
    p = {"router": rnd(64, 4), "w_in": rnd(4, 64, 128) * 0.1,
         "w_gate": rnd(4, 64, 128) * 0.1, "w_out": rnd(4, 128, 64) * 0.1}
    names = list(p)
    pspec = {"router": P("data", None), "w_in": P("model", "data", None),
             "w_gate": P("model", "data", None),
             "w_out": P("model", None, "data")}
    for tag, specs in (("groups", (P("data", None, None, None),
                                   P("data", None, None), 2)),
                       ("one group", None)):
        out[f"moe/{tag}"] = check(
            lambda x, *w: moe.moe_ff(x, dict(zip(names, w)), cfg,
                                     specs=specs),
            [rnd(4, 32, 64)] + [p[k] for k in names],
            [P("data", None, None)] + [pspec[k] for k in names])
    cache = rnd(4, 16, 2, 8)
    new = rnd(4, 1, 2, 8)

    def write(c, n):
        c = c.clone() if not isinstance(c, DTensor) else c
        pos = torch.tensor(9) if not isinstance(c, DTensor) else \
            sh.distribute(torch.tensor(9), P(), mesh)
        attn.write_cache(c, n, pos)
        return c
    out["write_cache/seq"] = check(write, [cache, new],
                                   [P("data", "model", None, None),
                                    P("data", None, None, None)],
                                   grads=False)
    out["write_cache/hd"] = check(write, [cache, new],
                                  [P("data", None, None, "model"),
                                   P("data", None, None, None)], grads=False)
    for eq, a_shape in (("bqhgd,bshd->bhgqs", (4, 1, 2, 2, 8)),
                        ("bhgqs,bshd->bqhgd", (4, 2, 2, 1, 16))):
        for tag, cs in (("seq", P("data", "model", None, None)),
                        ("hd", P("data", None, None, "model"))):
            out[f"decode_einsum/{eq}/{tag}"] = check(
                lambda a, c: (attn._einsum_on_cache if isinstance(c, DTensor)
                              else torch.einsum)(eq, a, c),
                [rnd(*a_shape), cache], [P(), cs], grads=False)
    return {k: {n: (a.float(), b.float()) for n, (a, b) in v.items()}
            for k, v in out.items()}


# the reference's compiled cells (``make_dryrun_reference.py``), split
# into parts that run in processes side by side
DRYRUN_PARTS = (
    (("granite-8b", "train_4k", "pod2_2x16x16"),),
    (("granite-8b", "train_4k", "pod1_16x16"),
     ("whisper-tiny", "train_4k", "pod1_16x16")),
    (("mamba2-1.3b", "prefill_32k", "pod1_16x16"),
     ("hymba-1.5b", "decode_32k", "pod1_16x16")),
    (("mixtral-8x22b", "decode_32k", "pod1_16x16"),),
)
DRYRUN_DEFAULTS = dict(fsdp=True, remat=None, microbatches=None,
                       seq_shard_decode=True, moe_ep=True, ssm_chunk=None,
                       act_sp=False, fsdp_gather_in_scan=False, pp=0)


def dryrun(path: str, part: str) -> None:
    """The port's dry run on the CPU under a fake process group of 512
    ranks, with the reference's ``main`` defaults, as JSON: part ``grid``:
    every (arch x shape x mesh) cell's status, ``model_flops`` and, where
    it runs, per-device argument bytes from the spec trees, and a planted
    fault (``build_step`` raising: the cell's row and ``main``'s exit
    code); part ``0``-``3``: the cells of ``DRYRUN_PARTS`` run whole."""
    from repro_torch.configs.base import SHAPES, all_configs, supports
    from repro_torch.interconnect.cost_model import model_flops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    out = {}
    if part == "grid":
        real = D.build_step

        def broken(*a, **k):
            raise RuntimeError("planted fault")
        D.build_step = broken
        try:
            rc = D.main(["--arch", "whisper-tiny", "--shape", "train_4k",
                         "--mesh", "pod1", "--device", "cpu"])
        finally:
            D.build_step = real
        out["fault"] = {"main_rc": rc}
    M.init_fake(512)
    try:
        meshes = dict(D.make_meshes("both", "cpu"))
        cfgs = all_configs()
        if part == "grid":
            D.build_step = broken
            try:
                out["fault"]["row"] = D.run_cell(
                    cfgs["granite-8b"], SHAPES["train_4k"],
                    meshes["pod1_16x16"], "pod1_16x16", device="cpu")
            finally:
                D.build_step = real
            cells = {}
            for arch, cfg in sorted(cfgs.items()):
                for sname, shape in SHAPES.items():
                    for mname, mesh in meshes.items():
                        rec = {"status": supports(cfg, shape) or "RUN",
                               "model_flops": model_flops(cfg, shape)}
                        if rec["status"] == "RUN":
                            rec["arg_bytes_per_dev"] = D.arg_bytes_per_dev(
                                cfg, shape, mesh, device="cpu",
                                **DRYRUN_DEFAULTS)
                        cells[f"{arch}/{sname}/{mname}"] = rec
            out["grid"] = cells
        else:
            rows = {}
            for arch, sname, mname in DRYRUN_PARTS[int(part)]:
                rows[f"{arch}/{sname}/{mname}"] = D.run_cell(
                    cfgs[arch], SHAPES[sname], meshes[mname], mname,
                    device="cpu", **DRYRUN_DEFAULTS)
            out["rows"] = rows
    finally:
        M.shutdown()
    pathlib.Path(path).write_text(json.dumps(out))


# the cells of ``dryrun_flags_reference.json`` (name: arch, shape, flags
# changed from ``DRYRUN_DEFAULTS``; all on the 16 x 16 pod), split into
# parts that run in processes side by side
DRYRUN_FLAGS = {
    "pp": ("hymba-1.5b", "train_4k", {"pp": 4}),
    "fsdp_off": ("whisper-tiny", "train_4k", {"fsdp": False}),
    "remat_full": ("whisper-tiny", "train_4k", {"remat": "full"}),
    "microbatches": ("whisper-tiny", "train_4k", {"microbatches": 2}),
    "seq_shard_decode_off": ("hymba-1.5b", "decode_32k",
                             {"seq_shard_decode": False}),
    "ssm_chunk": ("mamba2-1.3b", "prefill_32k", {"ssm_chunk": 128}),
    "act_sp": ("whisper-tiny", "train_4k", {"act_sp": True}),
    "fsdp_gather_in_scan": ("whisper-tiny", "train_4k",
                            {"fsdp_gather_in_scan": True}),
}
DRYRUN_FLAGS_PARTS = (("pp",), ("ssm_chunk", "seq_shard_decode_off"),
                      ("fsdp_off", "remat_full", "microbatches"),
                      ("act_sp", "fsdp_gather_in_scan"))


def dryrun_flags(path: str, part: str) -> None:
    """The cells of ``DRYRUN_FLAGS_PARTS[part]`` run whole by the port's
    dry run on the CPU under a fake process group of 512 ranks, as JSON
    rows keyed by name."""
    from repro_torch.configs.base import SHAPES, all_configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_fake(512)
    try:
        (mname, mesh), = D.make_meshes("pod1", "cpu")
        rows = {}
        for name in DRYRUN_FLAGS_PARTS[int(part)]:
            arch, sname, flags = DRYRUN_FLAGS[name]
            rows[name] = D.run_cell(all_configs()[arch], SHAPES[sname], mesh,
                                    mname, device="cpu",
                                    **dict(DRYRUN_DEFAULTS, **flags))
    finally:
        M.shutdown()
    pathlib.Path(path).write_text(json.dumps(rows))


SC_VARIANTS = {"default": {}, "no_fsdp": {"fsdp": False},
               "no_ep": {"ep": False}, "no_tp": {"tp": False},
               "no_shard_vocab": {"shard_vocab": False},
               "seq_shard_decode": {"seq_shard_decode": True}}


if __name__ == "__main__":
    globals()[sys.argv[1]](*sys.argv[2:])
