"""The port's examples (``examples/torch_quickstart.py``,
``torch_serve_lm.py``, ``torch_train_lm.py``) on the CPU.

- quickstart's six points (4C4M in three fabrics at loads 1.0 and 0.05,
  p_mem 0.2) at a short budget, 300 cycles with 60 of warm-up, equal
  the JAX package's ``run_point`` on each recorded by
  ``torch_fixtures/make_quickstart_reference.py`` in
  ``quickstart_reference.json`` (``short``): integers exact, floats rel
  1e-6, NaN where the reference has NaN; the rows held against another
  fabric's reference fail; its printed table has a row per fabric.
- ``torch_serve_lm.py`` (mamba2-1.3b smoke, 6 requests on 3 slots) and
  ``torch_train_lm.py --fast`` (hymba-1.5b smoke, 40 steps, checkpoints
  every 20 into a temporary directory) run with ``--device cpu`` and
  their own checks hold; the ~100M hymba member is registered in the
  port's registry with the JAX script's widths.
- None of the examples imports JAX or the JAX package.
"""
import json
import math
import pathlib
import re
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.constants import SimParams  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))

import torch_quickstart  # noqa: E402
import torch_serve_lm  # noqa: E402
import torch_train_lm  # noqa: E402

FIXTURE = ROOT / "tests" / "torch_fixtures" / "quickstart_reference.json"
EXAMPLES = ["torch_quickstart.py", "torch_serve_lm.py", "torch_train_lm.py"]
INTS = ("pkts_delivered", "flits_delivered", "flits_injected", "cycles_run",
        "drain_cycle")
FLOATS = ("offered_load", "throughput", "bw_gbps_core", "avg_pkt_latency",
          "avg_pkt_energy_pj", "energy_pj_bit")
REL = 1e-6


@pytest.fixture(scope="module")
def short():
    rec = json.loads(FIXTURE.read_text())["short"]
    sim = SimParams(**rec["sim"])
    return rec, torch_quickstart.rows(sim, device="cpu")


def _mismatches(got, want) -> list:
    ms = [(f.name, m) for f, sat, low in got for m in (sat, low)]
    bad = []
    for (fab, m), w in zip(ms, want):
        if fab != w["fabric"]:
            bad.append((fab, w["fabric"]))
        for k in INTS:
            if int(getattr(m, k)) != w["metrics"][k]:
                bad.append((fab, k))
        for k in FLOATS:
            a, b = float(getattr(m, k)), w["metrics"][k]
            if not (math.isnan(a) and math.isnan(b)
                    or abs(a - b) <= REL * max(abs(b), 1e-30)):
                bad.append((fab, k, a, b))
    return bad


def test_quickstart_rows_equal_reference(short):
    rec, got = short
    assert len(got) == 3 and len(rec["points"]) == 6
    assert _mismatches(got, rec["points"]) == []


def test_quickstart_rows_of_another_fabric_fail(short):
    rec, got = short
    shifted = rec["points"][2:] + rec["points"][:2]
    assert _mismatches(got, shifted)


def test_quickstart_table_and_budget(short):
    _, got = short
    lines = torch_quickstart.table(got).splitlines()
    assert [ln.split()[0] for ln in lines[1:]] == \
        ["SUBSTRATE", "INTERPOSER", "WIRELESS"]
    script = json.loads(FIXTURE.read_text())["script"]["sim"]
    sim = torch_quickstart.SIM
    assert script == {"cycles": sim.cycles, "warmup": sim.warmup,
                      "seed": sim.seed} == {"cycles": 4000, "warmup": 800,
                                            "seed": sim.seed}


def test_serve_lm_on_cpu():
    out = torch_serve_lm.main(["--device", "cpu"])
    assert out["tokens"] == 6 * 12


def test_train_lm_fast_on_cpu():
    out = torch_train_lm.main(["--fast", "--device", "cpu"])
    assert len(out["losses"]) == 40
    assert out["losses"][-1] < out["losses"][0]


def test_train_lm_registers_the_100m_member():
    from repro_torch.configs.base import REGISTRY
    try:
        cfg = torch_train_lm.hymba_100m()
        assert REGISTRY["hymba-100m"] is cfg
    finally:                      # other tests read the whole registry
        REGISTRY.pop("hymba-100m", None)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab, cfg.ssm_head_dim,
            cfg.sliding_window) == ("hybrid", 10, 768, 12, 6, 64, 2304,
                                    32001, 48, 512)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_neither_jax_nor_the_reference(name):
    src = (ROOT / "examples" / name).read_text()
    assert not re.search(r"^\s*(import jax|from jax|import repro\b|"
                         r"from repro\b)", src, re.M)
