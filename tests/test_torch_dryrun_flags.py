"""The port's dry run (``launch/dryrun.py``) under the flags of ``main``
that no cell of ``dryrun_reference.json`` uses, against the reference's
compiled cells recorded by
``torch_fixtures/make_dryrun_flags_reference.py`` in
``dryrun_flags_reference.json`` (one cell per flag, on the smallest arch
and shape that exercises it, the 16 x 16 pod).

Each cell is held as ``test_torch_dryrun.py`` holds the reference's six:
the same status; the bytes of the arguments some op reads equal XLA's
``argument_size_in_bytes`` and the bytes of every argument the declared
shardings'; dot FLOPs within ``FLOPS_TOL`` of the HLO count.  The
``--pp 4`` cell (hymba-1.5b ``train_4k``: 16 stages of 2 layers, 4
microbatches) also has its hand-offs counted as collective-permutes:
2 (M + S - 1) of them, forward and backward, each the rank's f32
boundary buffer, beside the reference's trip-expanded
``collective-permute``s, whose two hand-offs (forward and transposed)
move the same bytes a device.

The port's side runs in four subprocesses side by side (each its own
fake group of 512 ranks), writing under ``tmp_path_factory`` only.
"""
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES, get_config  # noqa: E402

import torch_dist  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "torch_fixtures" / "dryrun_flags_reference.json"
FLOPS_TOL = 0.10            # dot FLOPs against the reference's HLO count
TIMEOUT_S = 240             # each subprocess
NAMES = list(torch_dist.DRYRUN_FLAGS)
_BYTES = {"f32": 4, "bf16": 2, "s32": 4}


@pytest.fixture(scope="module")
def reference():
    rec = json.loads(FIXTURE.read_text())
    return {r["name"]: r for r in rec["cells"]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_flags")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    parts = range(len(torch_dist.DRYRUN_FLAGS_PARTS))
    procs = {p: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist.py"),
         "dryrun_flags", str(out / f"{p}.json"), str(p)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in parts}
    logs = {}
    try:
        for p, proc in procs.items():
            logs[p], _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rows = {}
    for p, proc in procs.items():
        assert proc.returncode == 0, (p, logs[p][-3000:])
        rows.update(json.loads((out / f"{p}.json").read_text()))
    return rows


def test_the_fixture_has_every_flag(reference):
    assert sorted(reference) == sorted(NAMES)
    for name, (arch, shape, flags) in torch_dist.DRYRUN_FLAGS.items():
        rec = reference[name]
        assert (rec["arch"], rec["shape"], rec["mesh"]) == \
            (arch, shape, "pod1_16x16")
        assert rec["flags"] == flags


@pytest.mark.parametrize("name", NAMES)
def test_status_equals_reference(port, reference, name):
    assert port[name]["status"] == reference[name]["status"] == "OK", \
        port[name].get("traceback", "")


@pytest.mark.parametrize("name", NAMES)
def test_arg_bytes_equal_reference(port, reference, name):
    got, want = port[name], reference[name]
    assert got["read_arg_bytes_per_dev"] == want["argument_size_in_bytes"]
    assert got["arg_bytes_per_dev"] == want["declared_arg_bytes_per_dev"]


@pytest.mark.parametrize("name", NAMES)
def test_flops_within_tolerance_of_hlo(port, reference, name):
    got, want = port[name], reference[name]
    ratio = got["flops_per_dev"] / want["flops_per_dev"]
    assert abs(ratio - 1) <= FLOPS_TOL, ratio
    assert got["model_flops"] == want["model_flops"]


def _pp_boundary_bytes() -> tuple:
    """(ticks, per-device bytes of the f32 boundary buffer) of the --pp
    cell: Bm = B / M rows over the 16 data ranks, S x d each."""
    arch, shape, flags = torch_dist.DRYRUN_FLAGS["pp"]
    cfg, sh = get_config(arch), SHAPES[shape]
    n_stages, n_micro, data = 16, flags["pp"], 16
    rows = sh.global_batch // n_micro
    return (n_micro + n_stages - 1,
            rows * sh.seq_len * cfg.d_model * 4 // data)


def test_pp_hand_offs_are_collective_permutes(port, reference):
    ticks, each = _pp_boundary_bytes()
    assert (ticks, each) == (19, 104_857_600)
    perms = {k: v for k, v in port["pp"]["calls_by_group"].items()
             if k.startswith("collective-permute")}
    assert list(perms) == ["collective-permute g=16 stride=1"]
    n, payload, wire = perms["collective-permute g=16 stride=1"]
    assert n == 2 * ticks
    assert payload == wire == 2 * ticks * each
    assert port["pp"]["coll_by_op"]["collective-permute"] == 2 * ticks * each
    # the reference: the hand-off forward and transposed, each in the
    # 19-trip tick loop and each moving the same bytes a device; its one
    # other permute (the token ids' layout for the embedding) is not a
    # hand-off
    ref = reference["pp"]
    assert ref["coll_counts"]["collective-permute"] == 2 * ticks + 1
    hand = [p for p in ref["permutes"] if p["trip"] == ticks]
    assert len(hand) == 2
    for p in hand:
        m = re.match(r"(\w+)\[([\d,]*)\]", p["shape"])
        assert _BYTES[m.group(1)] * math.prod(
            int(x) for x in m.group(2).split(",")) == each
    rest = [p for p in ref["permutes"] if p["trip"] != ticks]
    assert [p["shape"].split("[")[0] for p in rest] == ["s32"]
