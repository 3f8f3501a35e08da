"""Multi-pod dry run: build every (architecture x input shape) step on the
production meshes and read its FLOPs, bytes, collectives and memory per
device (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 host devices.  The
port has no compiler: a cell is "compiled" by running rank 0's step once
on a fake process group of 512 ranks (``launch/mesh.py::init_fake``)
under ``FakeTensorMode``.  The parameters, optimizer state, batch and
cache are DTensors placed by the port's spec trees, so no byte is
allocated and no collective moves data; the train shapes go through
``torch.autograd``.  A sharding mismatch, a shape error or an operator
DTensor cannot place fails the cell, as a failed compile fails the
reference's.  ``interconnect/graph_traffic.py::StepAnalysis`` counts the
step's dot FLOPs, written bytes and collective wire bytes over the ops it
runs, and the cell is priced by a three-term ``Roofline`` on the H100
(``cost_model.H100``).  No kernel is launched (``impl="blockwise"``).

Usage (``--device cpu`` builds the meshes on the CPU; the default is the
card's device type):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu   # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \
      --shape train_4k --mesh pod1 [--fsdp 1] [--remat dots] [--json out]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import device as _device
from repro_torch.configs.base import SHAPES, all_configs, supports
from repro_torch.interconnect import graph_traffic as gt
from repro_torch.interconnect.cost_model import H100, Roofline, model_flops
from repro_torch.launch import mesh as M
from repro_torch.models.model import Model
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import P
from repro_torch.train.loop import (TrainConfig, make_serve_step,
                                    make_train_step)
from repro_torch.train.optimizer import AdamW

# per-arch settings of the reference's production cells (its
# ``ARCH_TUNING``)
ARCH_TUNING = {
    "llama3-405b": dict(remat="block", state_dtype=torch.bfloat16,
                        microbatches=4),
    "mixtral-8x22b": dict(remat="block", microbatches=4),
    "dbrx-132b": dict(remat="block", microbatches=4),
    "mamba2-1.3b": dict(ssm_chunk=256),
    # 37M params: TP=16 over d_model=384 is pure overhead — run pure DP
    "whisper-tiny": dict(tp=False),
    "starcoder2-7b": dict(remat="block"),
    "gemma-7b": dict(remat="block"),
    "granite-8b": dict(remat="block"),
    "llava-next-mistral-7b": dict(remat="block"),
}


def build_model(cfg, mesh, *, remat="dots", act_sp=False,
                moe_ep=True) -> Model:
    """The model of a cell on ``mesh``: the reference's activation,
    sequence-parallel attention and MoE dispatch specs."""
    sizes = M.axis_sizes(mesh)
    dp = sh.dp_axes(mesh)
    # --act-sp: Megatron-style sequence-parallel residual stream
    act_spec = P(dp, "model", None) if act_sp else P(dp, None, None)
    sp_specs = None
    if cfg.has_attention and cfg.n_heads % sizes["model"] != 0:
        # heads do not divide the model axis: sequence-parallel attention
        sp_specs = (P(dp, "model", None, None), P(dp, None, None, None))
    moe_specs = None
    if cfg.n_experts and moe_ep:
        # group-local dispatch: one group per DP shard
        G = math.prod(sizes[a] for a in dp)
        if moe_ep == 2 and cfg.n_experts % sizes["model"] == 0:
            buf_spec = P(dp, "model", None, None)  # expert parallelism
        else:
            buf_spec = P(dp, None, None, None)
        moe_specs = (buf_spec, P(dp, None, None), G)
    return Model(cfg, remat=remat, act_spec=act_spec, sp_specs=sp_specs,
                 moe_specs=moe_specs)


def build_step(cfg, shape, mesh, *, fsdp=True, remat=None, microbatches=None,
               state_dtype=torch.float32, seq_shard_decode=False,
               moe_ep=True, ssm_chunk=None, act_sp=False,
               fsdp_gather_in_scan=False, pp=0, device=None):
    """Return ``(step, args, pspecs)`` for one cell: ``step(*placed)``
    runs it on ``args`` (trees of meta tensors, the reference's abstract
    arguments) once they are placed by ``pspecs`` (``place``)."""
    tune = ARCH_TUNING.get(cfg.name, {})
    remat = remat if remat is not None else tune.get("remat", "dots")
    microbatches = microbatches if microbatches is not None else \
        tune.get("microbatches", 1)
    state_dtype = tune.get("state_dtype", state_dtype)
    tp = tune.get("tp", True)

    ssm_chunk = ssm_chunk or tune.get("ssm_chunk")
    if ssm_chunk:
        cfg = cfg.scaled(ssm_chunk=ssm_chunk)
    sizes = M.axis_sizes(mesh)
    model = build_model(cfg, mesh, remat=remat, act_sp=act_sp,
                        moe_ep=moe_ep)
    sc = sh.ShardingConfig(fsdp=fsdp, tp=tp,
                           seq_shard_decode=seq_shard_decode)
    pspec = model.param_specs()
    pps = sh.param_pspecs(cfg, pspec, mesh, sc)
    if fsdp and fsdp_gather_in_scan:
        def strip(spec):
            tail = tuple(spec)[1:]          # drop the stacked-layer dim
            return P(*[None if a == "data" else a for a in tail])
        model.fsdp_gather_specs = sh.tree_map(strip, pps["layers"])
    inputs = sh.meta(model.input_specs(shape))

    if shape.kind == "train":
        opt = AdamW(state_dtype=state_dtype)
        if pp:
            # pipeline parallelism over the model axis: layers stage-major
            # sharded on dim 0; drop "model" from intra-layer dims
            from repro_torch.train.pipeline import make_pp_loss

            def strip_model(spec):
                tail = [None if a == "model" else a for a in tuple(spec)[1:]]
                return P("model", *tail)
            pps = dict(pps)
            pps["layers"] = sh.tree_map(strip_model, pps["layers"])
            pp_loss = make_pp_loss(cfg, mesh, n_stages=sizes["model"],
                                   n_micro=pp, remat=remat or "full",
                                   device=device)

            class _PP:                       # make_train_step only needs .loss
                loss = staticmethod(pp_loss)
            model = _PP()
        step = make_train_step(model, opt,
                               TrainConfig(microbatches=microbatches),
                               grad_pspecs=pps)
        args = (pspec, opt.init_specs(pspec), inputs)
        specs = (pps, opt.state_pspecs(pps), sh.batch_pspecs(inputs, mesh))
    elif shape.kind == "prefill":
        def step(params, batch):
            # forward + loss against shifted tokens (scoring pass)
            b = dict(batch)
            b["labels"] = batch["tokens"]
            return model.loss(params, b)
        args = (pspec, inputs)
        specs = (pps, sh.batch_pspecs(inputs, mesh))
    else:  # decode
        step = make_serve_step(model)
        cache = model.decode_state_specs(shape.global_batch, shape.seq_len)
        tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                          device="meta")
        pos = torch.empty((), dtype=torch.int32, device="meta")
        args = (pspec, cache, tok, pos)
        specs = (pps, sh.cache_pspecs(cfg, cache, mesh, sc),
                 sh.batch_pspecs({"t": tok}, mesh)["t"], P())
    return step, args, specs


def local_shape(shape, spec, mesh) -> tuple:
    """Rank 0's shard shape of a tensor of ``shape`` placed by ``spec``
    (sanitized specs divide their dims evenly)."""
    sizes = M.axis_sizes(mesh)
    out = []
    for d, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        ax = () if axes is None else (axes if isinstance(axes, tuple)
                                      else (axes,))
        n = math.prod(sizes[a] for a in ax)
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {ax} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


def place(args, specs, mesh, device=None):
    """The trees of meta tensors ``args`` as DTensors on ``mesh`` placed by
    ``specs``, each backed by an empty local shard on ``device`` (call it
    under ``FakeTensorMode``: nothing is allocated)."""
    dev = _device.resolve(device)

    def one(m, spec):
        t = torch.empty(local_shape(m.shape, spec, mesh), dtype=m.dtype,
                        device=dev)
        return sh.as_placed(t, mesh, sh.placements(spec, mesh), m.shape)

    return tuple(sh.tree_map(one, a, s) for a, s in zip(args, specs))


def run_cell(cfg, shape, mesh, mesh_name: str, device=None, **kw) -> dict:
    t0 = time.perf_counter()
    skip = supports(cfg, shape)
    if skip:
        return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                "status": skip}
    try:
        step, args, specs = build_step(cfg, shape, mesh, device=device, **kw)
        with FakeTensorMode(), implicit_replication():
            placed = place(args, specs, mesh, device)
            flat = gt.flat_tensors(placed)
            mode = gt.StepAnalysis(flat)
            with mode:
                step(*placed)
        st = mode.stats()
        calls_by_group: dict = {}
        for c, wire in zip(mode.calls, mode.wires):
            rec = calls_by_group.setdefault(
                f"{c.op} g={c.group_size} stride={c.stride}", [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += c.payload_bytes
            rec[2] += wire
        n = math.prod(M.axis_sizes(mesh).values())
        peak_mem = st.peak_mem_per_dev
        rl = Roofline(
            arch=cfg.name, shape=shape.name, mesh=mesh_name,
            flops_per_dev=st.flops_per_dev,
            bytes_per_dev=st.bytes_per_dev,
            coll_bytes_per_dev=st.coll_bytes_per_dev,
            n_devices=n,
            model_flops=model_flops(cfg, shape),
            peak_mem_per_dev=peak_mem, hw=H100,
        )
        return {
            "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
            "status": "OK",
            "compile_s": round(time.perf_counter() - t0, 1),
            "flops_per_dev": rl.flops_per_dev,
            "bytes_per_dev": rl.bytes_per_dev,
            "coll_bytes_per_dev": rl.coll_bytes_per_dev,
            "coll_by_op": {k: round(v) for k, v in st.coll_by_op.items()},
            "mem_gb_per_dev": round(peak_mem / 1e9, 3),
            "t_compute_ms": rl.t_compute * 1e3,
            "t_memory_ms": rl.t_memory * 1e3,
            "t_collective_ms": rl.t_collective * 1e3,
            "bottleneck": rl.bottleneck,
            "model_flops": rl.model_flops,
            "useful_flop_ratio": rl.useful_flop_ratio,
            "roofline_fraction": rl.roofline_fraction,
            "fabric_energy_mj": rl.fabric_energy_mj(),
            "arg_bytes_per_dev": sum(gt.local_bytes(t) for t in flat),
            "read_arg_bytes_per_dev": st.read_arg_bytes,
            "peak_mem_per_dev": peak_mem,
            "n_collectives": st.n_collectives,
            # the collective sequence by op, group size and rank stride:
            # [calls, payload bytes, wire bytes]
            "calls_by_group": calls_by_group,
        }
    except Exception as e:  # a failing cell is a bug; record it loudly
        return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                "status": f"FAIL: {type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def arg_bytes_per_dev(cfg, shape, mesh, **kw) -> int:
    """Rank 0's bytes of every argument of the cell, from the spec trees
    alone (no step is run)."""
    _, args, specs = build_step(cfg, shape, mesh, **kw)
    return sum(math.prod(local_shape(m.shape, spec, mesh)) * m.element_size()
               for a, s in zip(args, specs)
               for m, spec in zip(gt.flat_tensors(a), _flat_specs(s)))


def _flat_specs(tree) -> list:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _flat_specs(v)]
    return [s for v in tree for s in _flat_specs(v)]


def make_meshes(which: str = "both", device=None) -> list:
    meshes = []
    if which in ("pod1", "both"):
        meshes.append(("pod1_16x16", M.make_production_mesh(
            multi_pod=False, device=device)))
    if which in ("pod2", "both"):
        meshes.append(("pod2_2x16x16", M.make_production_mesh(
            multi_pod=True, device=device)))
    return meshes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-shard-decode", type=int, default=1)
    ap.add_argument("--moe-ep", type=int, default=1)
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--act-sp", type=int, default=0)
    ap.add_argument("--fsdp-gather-in-scan", type=int, default=0)
    ap.add_argument("--pp", type=int, default=0,
                    help="pipeline microbatches; stages = model axis size")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None,
                    help="the meshes' device type (default: the card)")
    args = ap.parse_args(argv)

    M.init_fake(512)
    try:
        results = run_grid(args)
    finally:
        M.shutdown()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"].startswith("SKIP") for r in results)
    n_fail = len(results) - n_ok - n_skip
    print(f"dryrun: {n_ok} OK, {n_skip} skipped, {n_fail} FAILED",
          flush=True)
    return 1 if n_fail else 0


def run_grid(args) -> list:
    meshes = make_meshes(args.mesh, args.device)
    cfgs = all_configs()
    archs = [args.arch] if args.arch else sorted(cfgs)
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = []
    for arch in archs:
        cfg = cfgs[arch]
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            for mesh_name, mesh in meshes:
                r = run_cell(cfg, shape, mesh, mesh_name, device=args.device,
                             fsdp=bool(args.fsdp), remat=args.remat,
                             microbatches=args.microbatches,
                             seq_shard_decode=bool(args.seq_shard_decode),
                             moe_ep=bool(args.moe_ep),
                             ssm_chunk=args.ssm_chunk,
                             act_sp=bool(args.act_sp),
                             fsdp_gather_in_scan=bool(
                                 args.fsdp_gather_in_scan),
                             pp=args.pp)
                results.append(r)
                status = r["status"]
                extra = ""
                if status == "OK":
                    extra = (f" mem={r['mem_gb_per_dev']}GB "
                             f"tc={r['t_compute_ms']:.2f}ms "
                             f"tm={r['t_memory_ms']:.2f}ms "
                             f"tx={r['t_collective_ms']:.2f}ms "
                             f"bott={r['bottleneck']} "
                             f"rf={r['roofline_fraction']:.3f}")
                print(f"{arch:24s} {shape_name:12s} {mesh_name:12s} "
                      f"{status}{extra}", flush=True)
    return results


if __name__ == "__main__":
    sys.exit(main())
