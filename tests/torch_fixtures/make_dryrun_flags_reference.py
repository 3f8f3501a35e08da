"""Write ``dryrun_flags_reference.json``: the JAX package's compiled dry
run (``repro/launch/dryrun.py``) for the flags of ``main`` that no cell
of ``dryrun_reference.json`` uses, held against the port by
``tests/test_torch_dryrun_flags.py`` (and the ``--pp`` cell by
``chip_smoke.py``'s dry-run phase).

Each cell of ``CELLS`` is compiled through the reference's own
``run_cell`` on 512 host devices with ``main``'s defaults and one flag
changed, on the smallest arch and shape that exercises the flag, and is
recorded as ``make_dryrun_reference.py`` records its compiled cells (the
row, ``memory_analysis()``'s bytes, the declared and kept argument bytes
per device), with:

- ``coll_counts``: the trip-expanded count of each collective op of
  ``hlo_traffic.collective_sequence`` (a call inside a ``while`` counts
  its trip count times);
- ``permutes``: every ``collective-permute`` of the HLO text, in text
  order, with its result shape and the trip count of its computation
  (the reference's HLO reader reads their operand bytes as 0: their
  operand shapes are not inline).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_dryrun_flags_reference.py

Takes ~2-3 minutes and a few GB of host memory (512 host devices, set
before JAX is imported, as ``make_dryrun_reference.py`` sets them).
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=512")

import collections  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402

from repro.configs.base import SHAPES, all_configs  # noqa: E402
from repro.interconnect import hlo_traffic as H  # noqa: E402
from repro.launch import dryrun as D  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402

HERE = pathlib.Path(__file__).parent
OUT = HERE / "dryrun_flags_reference.json"

_spec = importlib.util.spec_from_file_location(
    "make_dryrun_reference", HERE / "make_dryrun_reference.py")
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
DEFAULTS = _base.DEFAULTS

# (name, arch, shape, flags changed from main's defaults); all on pod1
CELLS = [
    ("pp", "hymba-1.5b", "train_4k", {"pp": 4}),
    ("fsdp_off", "whisper-tiny", "train_4k", {"fsdp": False}),
    ("remat_full", "whisper-tiny", "train_4k", {"remat": "full"}),
    ("microbatches", "whisper-tiny", "train_4k", {"microbatches": 2}),
    ("seq_shard_decode_off", "hymba-1.5b", "decode_32k",
     {"seq_shard_decode": False}),
    ("ssm_chunk", "mamba2-1.3b", "prefill_32k", {"ssm_chunk": 128}),
    ("act_sp", "whisper-tiny", "train_4k", {"act_sp": True}),
    ("fsdp_gather_in_scan", "whisper-tiny", "train_4k",
     {"fsdp_gather_in_scan": True}),
]
MESH = "pod1_16x16"


def trip_counts(hlo: str) -> dict:
    """{while body: trip count} of the module."""
    comps = H._parse_computations(hlo)
    trip = {}
    for lines in comps.values():
        for line in lines:
            if not re.search(r"while\(", line):
                continue
            bm = re.search(r"body=\{?%?([\w\.\-]+)", line)
            cm = re.search(r"condition=\{?%?([\w\.\-]+)", line)
            if bm:
                t = H._trip_count(comps.get(cm.group(1), [])) if cm else 1
                trip[bm.group(1)] = max(trip.get(bm.group(1), 1), t)
    return trip


def permutes(hlo: str) -> list:
    """Each collective-permute's result shape and the trip count of the
    while body it sits in (1 outside one), in text order."""
    trip = trip_counts(hlo)
    out = []
    for name, lines in H._parse_computations(hlo).items():
        for line in lines:
            m = re.search(r"=\s*(\S+)\s+collective-permute\(", line)
            if m:
                out.append({"computation": name, "shape": m.group(1),
                            "trip": trip.get(name, 1),
                            "source_target_pairs": (
                                re.search(r"source_target_pairs=\{\{(\d+,\d+)"
                                          r"\}?,?\{?(\d+,\d+)?", line)
                                .group(0)[len("source_target_pairs="):])})
    return out


def main() -> None:
    t_all = time.perf_counter()
    mesh = make_production_mesh(multi_pod=False)
    cfgs = all_configs()
    rows = []
    for name, arch, shape_name, flags in CELLS:
        cfg, shape = cfgs[arch], SHAPES[shape_name]
        kw = dict(DEFAULTS, **flags)
        t0 = time.perf_counter()
        row = D.run_cell(cfg, shape, mesh, MESH, **kw)
        row["compile_s_total"] = time.perf_counter() - t0
        row.update(name=name, flags=flags)
        if row["status"] == "OK":
            fn, fargs = D.build_step(cfg, shape, mesh, **kw)
            with mesh:
                compiled = fn.lower(*fargs).compile()
            ma = compiled.memory_analysis()
            hlo = compiled.as_text()
            total, kept, _ = _base.arg_bytes(fn, fargs, mesh)
            counts = collections.Counter()
            for c in H.collective_sequence(hlo, mesh.size):
                counts[c.op] += c.repeat
            row.update(argument_size_in_bytes=int(ma.argument_size_in_bytes),
                       temp_size_in_bytes=int(ma.temp_size_in_bytes),
                       output_size_in_bytes=int(ma.output_size_in_bytes),
                       declared_arg_bytes_per_dev=total,
                       kept_arg_bytes_per_dev=kept,
                       coll_counts=dict(counts), permutes=permutes(hlo))
            assert kept == ma.argument_size_in_bytes, (name, kept, ma)
        rows.append(row)
        print(f"{name:22s} {arch:14s} {shape_name:12s} "
              f"{row['status'][:60]} {row['compile_s_total']:.1f}s",
              flush=True)
    OUT.write_text(json.dumps({
        "jax": jax.__version__, "defaults": DEFAULTS, "mesh": MESH,
        "seconds": time.perf_counter() - t_all, "cells": rows}, indent=1))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
