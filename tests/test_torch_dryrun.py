"""The port's multi-pod dry run (``launch/dryrun.py``: ``build_step`` and
``run_cell`` under a fake process group of 512 ranks and
``FakeTensorMode``; ``interconnect/graph_traffic.py``'s counts) against
the reference's compiled dry run, recorded by
``torch_fixtures/make_dryrun_reference.py`` in ``dryrun_reference.json``
(JAX is not run here: its dry run forces 512 host devices at import).

- Every (arch x shape x mesh) cell of both production meshes: the skip
  reason, ``model_flops`` and, where the cell runs, the per-device bytes
  of every argument equal the reference's exactly (the bytes of the
  shardings its ``build_step`` declares).
- The reference's six compiled cells, run whole by the port: the same
  status; the bytes of the arguments some op reads equal XLA's
  ``argument_size_in_bytes`` (a compiled program drops an unused
  argument, mamba2's ``ln_ssm``); dot FLOPs within ``FLOPS_TOL`` of the
  HLO count; collective bytes on every train cell.
- A planted fault: a ``build_step`` that raises gives a ``FAIL:`` row
  with its traceback, and ``main`` exits 1.
- The H100's constants are the ones ``chip_smoke.py`` uses.

The port's side runs in five subprocesses side by side (each its own
fake group, none left behind), writing under ``tmp_path_factory`` only.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base  # noqa: E402
from repro_torch.interconnect import cost_model as cm  # noqa: E402

import torch_dist  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "torch_fixtures" / "dryrun_reference.json"
FLOPS_TOL = 0.10            # dot FLOPs against the reference's HLO count
MESHES = ("pod1_16x16", "pod2_2x16x16")
CELLS = [(a, s, m) for a in sorted(base.all_configs()) for s in base.SHAPES
         for m in MESHES]
COMPILED = [c for part in torch_dist.DRYRUN_PARTS for c in part]
TIMEOUT_S = 240             # each subprocess


def _key(a, s, m) -> str:
    return f"{a}/{s}/{m}"


@pytest.fixture(scope="module")
def reference():
    rec = json.loads(FIXTURE.read_text())
    return {"grid": {_key(r["arch"], r["shape"], r["mesh"]): r
                     for r in rec["grid"]},
            "compiled": {_key(r["arch"], r["shape"], r["mesh"]): r
                         for r in rec["compiled"]}}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    parts = ["grid"] + [str(i) for i in range(len(torch_dist.DRYRUN_PARTS))]
    procs = {p: subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dist.py"), "dryrun",
         str(out / f"{p}.json"), p], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for p in parts}
    logs = {}
    try:
        for p, proc in procs.items():
            logs[p], _ = proc.communicate(timeout=TIMEOUT_S)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for p, proc in procs.items():
        assert proc.returncode == 0, (p, logs[p][-3000:])
    res = {"rows": {}}
    for p in parts:
        got = json.loads((out / f"{p}.json").read_text())
        res["rows"].update(got.get("rows", {}))
        res.update({k: v for k, v in got.items() if k != "rows"})
    return res


def test_the_fixture_has_every_cell(reference):
    assert sorted(reference["grid"]) == sorted(_key(*c) for c in CELLS)
    assert {_key(*c) for c in COMPILED} <= set(reference["compiled"])


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: _key(*c))
def test_arg_bytes_equal_reference(port, reference, cell):
    got, want = port["grid"][_key(*cell)], reference["grid"][_key(*cell)]
    assert got["status"] == want["status"]
    if want["status"] == "RUN":
        assert got["arg_bytes_per_dev"] == want["arg_bytes_per_dev"]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: _key(*c))
def test_model_flops_equal_reference(port, reference, cell):
    got, want = port["grid"][_key(*cell)], reference["grid"][_key(*cell)]
    assert got["model_flops"] == want["model_flops"]


@pytest.mark.parametrize("cell", COMPILED, ids=lambda c: _key(*c))
def test_compiled_cell_status_equals_reference(port, reference, cell):
    got, want = port["rows"][_key(*cell)], reference["compiled"][_key(*cell)]
    assert got["status"] == want["status"], got.get("traceback", "")


@pytest.mark.parametrize("cell", COMPILED, ids=lambda c: _key(*c))
def test_read_arg_bytes_equal_argument_size(port, reference, cell):
    got, want = port["rows"][_key(*cell)], reference["compiled"][_key(*cell)]
    assert got["read_arg_bytes_per_dev"] == want["argument_size_in_bytes"]
    assert got["arg_bytes_per_dev"] == want["declared_arg_bytes_per_dev"]


@pytest.mark.parametrize("cell", COMPILED, ids=lambda c: _key(*c))
def test_flops_within_tolerance_of_hlo(port, reference, cell):
    got, want = port["rows"][_key(*cell)], reference["compiled"][_key(*cell)]
    ratio = got["flops_per_dev"] / want["flops_per_dev"]
    assert abs(ratio - 1) <= FLOPS_TOL, ratio
    assert got["model_flops"] == want["model_flops"]


@pytest.mark.parametrize("cell", [c for c in COMPILED
                                  if c[1].startswith("train")],
                         ids=lambda c: _key(*c))
def test_train_cells_move_collective_bytes(port, cell):
    row = port["rows"][_key(*cell)]
    assert row["coll_bytes_per_dev"] > 0
    assert sum(row["coll_by_op"].values()) > 0


def test_planted_build_step_fault_fails_the_cell_and_main(port):
    row = port["fault"]["row"]
    assert row["status"].startswith("FAIL: RuntimeError: planted fault")
    assert "planted fault" in row["traceback"]
    assert "Traceback" in row["traceback"]
    assert port["fault"]["main_rc"] == 1


def test_h100_constants_are_the_smokes():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.H100 is cm.H100
    assert smoke.H100_BF16_FLOPS == cm.H100.peak_flops == 989e12
    assert smoke.H100_BYTES_PER_S == cm.H100.hbm_bw == 3.35e12
    assert smoke.H100_F32_FLOPS == cm.H100_F32_FLOPS == 67e12
    assert cm.H100.ici_bw == 450e9
    assert cm.H100.hbm_bytes == 85_017_493_504
    # the fabric energies stay the paper's
    for k in ("e_ici_pj_bit", "e_dcn_pj_bit", "e_wireless_pj_bit"):
        assert getattr(cm.H100, k) == getattr(cm.V5E, k)
