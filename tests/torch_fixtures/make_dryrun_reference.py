"""Write ``dryrun_reference.json``: the JAX package's multi-pod dry run
(``repro/launch/dryrun.py``) for the port's ``launch/dryrun.py``
(``tests/test_torch_dryrun.py``, ``chip_smoke.py`` phase 27).

It records, with ``main``'s default flags (``fsdp``, ``seq_shard_decode``
and ``moe_ep`` on, the per-arch ``ARCH_TUNING``):

- ``compiled``: the cells of ``COMPILED`` (and of ``--extra``), each
  lowered and compiled through the reference's own ``run_cell`` on 512
  host devices: its row, ``memory_analysis()``'s argument, temp and
  output bytes, and the per-device argument bytes that ``build_step``
  declares (below), with the compile seconds;
- ``grid``: every (arch x shape x mesh) cell, without compiling: the
  ``supports()`` skip reason, ``model_flops``, and for a cell that runs
  the per-device argument bytes of the shardings ``build_step`` puts on
  its arguments, read from the lowering's own ``in_shardings`` (each
  argument's shard shape times its item size, summed) and, apart, the
  sum over the arguments the compiled program keeps (unused ones are
  pruned by ``jit``).

On the compiled cells it asserts that the kept sum equals
``argument_size_in_bytes``; if the sum over every argument does not, both
are recorded.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_dryrun_reference.py [--extra ARCH:SHAPE:MESH ...]

Takes ~2 minutes and a few GB of host memory (it sets ``XLA_FLAGS`` for
512 host devices itself, before JAX is imported).  ``--extra`` compiles
more cells, as ``ARCH:SHAPE:MESH`` (a cell the port fails, to see whether
the reference fails it too).
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

from repro.configs.base import SHAPES, all_configs, supports  # noqa: E402
from repro.interconnect.cost_model import model_flops  # noqa: E402
from repro.launch import dryrun as D  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402

OUT = pathlib.Path(__file__).parent / "dryrun_reference.json"

# main's defaults, as main passes them to run_cell
DEFAULTS = dict(fsdp=True, remat=None, microbatches=None,
                seq_shard_decode=True, moe_ep=True, ssm_chunk=None,
                act_sp=False, fsdp_gather_in_scan=False, pp=0)

COMPILED = [("whisper-tiny", "train_4k", "pod1_16x16"),
            ("granite-8b", "train_4k", "pod1_16x16"),
            ("mamba2-1.3b", "prefill_32k", "pod1_16x16"),
            ("hymba-1.5b", "decode_32k", "pod1_16x16"),
            ("mixtral-8x22b", "decode_32k", "pod1_16x16"),
            ("granite-8b", "train_4k", "pod2_2x16x16")]


def _shard_bytes(shardings, avals) -> list:
    out = []
    for sh, aval in zip(shardings, avals):
        shape = sh.shard_shape(tuple(aval.shape)) \
            if hasattr(sh, "shard_shape") else tuple(aval.shape)
        out.append(math.prod(shape) * aval.dtype.itemsize)
    return out


def arg_bytes(fn, args, mesh) -> tuple:
    """(bytes over every argument, bytes over the arguments the compiled
    program keeps, number of arguments) per device: the trace's
    in_shardings (one per argument, as ``build_step`` declares them) over
    the arguments' shapes, and the lowering's (unused arguments pruned)
    over its global avals."""
    with mesh:
        traced = fn.trace(*args)
        lowered = traced.lower()
    every = _shard_bytes(traced._params["in_shardings"],
                         jax.tree.leaves(args))
    ca = lowered._lowering.compile_args
    kept = _shard_bytes(ca["in_shardings"], ca["global_in_avals"])
    return int(sum(every)), int(sum(kept)), len(every)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--extra", nargs="*", default=[],
                    help="more cells to compile, ARCH:SHAPE:MESH")
    args = ap.parse_args()
    t_all = time.perf_counter()
    meshes = {"pod1_16x16": make_production_mesh(multi_pod=False),
              "pod2_2x16x16": make_production_mesh(multi_pod=True)}
    cfgs = all_configs()

    grid = []
    for arch in sorted(cfgs):
        cfg = cfgs[arch]
        for shape_name, shape in SHAPES.items():
            for mesh_name, mesh in meshes.items():
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "status": supports(cfg, shape) or "RUN",
                       "model_flops": model_flops(cfg, shape)}
                if rec["status"] == "RUN":
                    fn, fargs = D.build_step(cfg, shape, mesh, **DEFAULTS)
                    total, kept, n = arg_bytes(fn, fargs, mesh)
                    rec.update(arg_bytes_per_dev=total,
                               kept_arg_bytes_per_dev=kept, n_args=n)
                grid.append(rec)
                print(f"grid {arch:24s} {shape_name:12s} {mesh_name:12s} "
                      f"{rec['status']} {rec.get('arg_bytes_per_dev')}",
                      flush=True)

    compiled = []
    cells = list(COMPILED) + [tuple(c.split(":")) for c in args.extra]
    for arch, shape_name, mesh_name in cells:
        cfg, shape, mesh = cfgs[arch], SHAPES[shape_name], meshes[mesh_name]
        t0 = time.perf_counter()
        row = D.run_cell(cfg, shape, mesh, mesh_name, **DEFAULTS)
        row["compile_s_total"] = time.perf_counter() - t0
        if row["status"] == "OK":
            fn, fargs = D.build_step(cfg, shape, mesh, **DEFAULTS)
            with mesh:
                ma = fn.lower(*fargs).compile().memory_analysis()
            total, kept, _ = arg_bytes(fn, fargs, mesh)
            row.update(argument_size_in_bytes=int(ma.argument_size_in_bytes),
                       temp_size_in_bytes=int(ma.temp_size_in_bytes),
                       output_size_in_bytes=int(ma.output_size_in_bytes),
                       declared_arg_bytes_per_dev=total,
                       kept_arg_bytes_per_dev=kept)
            assert kept == ma.argument_size_in_bytes, (arch, shape_name,
                                                       kept, ma)
        compiled.append(row)
        print(f"compiled {arch:24s} {shape_name:12s} {mesh_name:12s} "
              f"{row['status'][:60]} {row['compile_s_total']:.1f}s",
              flush=True)

    OUT.write_text(json.dumps({
        "jax": jax.__version__, "flags": DEFAULTS,
        "seconds": time.perf_counter() - t_all,
        "compiled": compiled, "grid": grid}, indent=1))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
