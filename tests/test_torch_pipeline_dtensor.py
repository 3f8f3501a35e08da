"""The pipeline (``train/pipeline.py::make_pp_loss``) on DTensors, the
dry run's ``--pp`` path, with real values on four gloo ranks: a (2, 2)
("data", "model") mesh, 2 stages of one layer each and 2 microbatches,
the parameters and batch placed by ``launch/dryrun.py::build_step``'s
``--pp`` specs (the stacked layers split over "model", FSDP and the
batch over "data"), for granite-8b's and hymba-1.5b's smoke configs
(``torch_dist.pipeline_dtensor``).

- Against the JAX package's pipeline compiled on the same (2, 2) mesh,
  its parameters and batch placed as the reference's dry run places them,
  on the same weights and batch (``pp_dtensor_reference.npz``,
  ``make_pp_dtensor_reference.py``): the loss to ``REF_LOSS_RTOL`` and
  every gradient, each layer's slice of a stacked leaf on its own, to
  ``REF_GRAD_L2`` of its norm (``|port - ref| / |ref|``), on every rank.
  Both run each stage in bf16 and round apart; the limits are about twice
  the readings (loss: granite 4.9e-6, hymba 3.4e-4; gradients: granite
  at most 2.4e-2, hymba 0.127, at the SSM's ``dt_bias``, whose gradient
  amplifies the roundings: the port's own one-device ``Model.loss`` is
  0.168 from the reference there).  A wrong transpose, or a hand-off
  whose gradient does not come back, is off by the slice's whole norm.
  ``PYTHONPATH=src python tests/test_torch_pipeline_dtensor.py`` prints
  the readings.
- The loss equals the port's one-device ``Model.loss``'s on the same
  weights and batch, and granite's every gradient, within the
  reference's own bound between its pipeline and its sequential loss
  (``tests/test_pipeline.py``: loss rel 2e-2, gradients rtol 0.15 and
  atol 0.02).  The hybrid stage's semantics are also held in f32: one
  hybrid layer on an x split on its width, its loss to rel 1e-6 and
  every gradient to 1e-5 of the leaf's largest entry (measured: ~1e-6).
- The collective sequence: 2 (M + S - 1) = 6 hand-offs, each a
  ``collective-permute`` over the 2-rank "model" group (stride 1) of the
  rank's f32 boundary buffer (2 rows x 32 x 64 / 2 ranks x 4 bytes), and
  no all-to-all.
- A planted fault, the hand-off's backward sending nothing back, must be
  caught against the reference, for both archs.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist  # noqa: E402

ARCHS = ["granite-8b", "hymba-1.5b"]
LOSS_RTOL, RTOL, ATOL = 2e-2, 0.15, 0.02
REF_LOSS_RTOL = {"granite-8b": 1e-5, "hymba-1.5b": 1e-3}
REF_GRAD_L2 = {"granite-8b": 0.05, "hymba-1.5b": 0.25}
F32_LOSS_RTOL, F32_GRAD_REL = 1e-6, 1e-5
HAND_OFFS = 2 * (2 + 2 - 1)
BOUNDARY_BYTES = 2 * 32 * 64 // 2 * 4
REFERENCE = pathlib.Path(__file__).parent / "torch_fixtures" / \
    "pp_dtensor_reference.npz"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist.run("pipeline_dtensor", 4,
                          tmp_path_factory.mktemp("pp_dtensor"))


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    return torch_dist.run("pipeline_dtensor", 4,
                          tmp_path_factory.mktemp("pp_dtensor_fault"),
                          fault="handoff_backward")


def _ref_errors(rec, arch, which: int = 1) -> dict:
    """Each gradient's largest relative L2 error against the reference,
    over the layers' slices of a stacked leaf: the pipeline's
    (``which=1``) or the one-device ``Model.loss``'s (0)."""
    z = np.load(REFERENCE)
    errs = {}
    for k, pair in rec["grads"].items():
        g = pair[which]
        got, want = g.numpy(), z[f"{arch}/grad{k}"]
        pairs = zip(got, want) if "layers" in k else [(got, want)]
        errs[k] = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                      for a, b in pairs)
    return errs


def _grad_errors(rec) -> list:
    return [f"grad {k}: max err {float((a - b).abs().max())}"
            for k, (a, b) in rec["grads"].items()
            if not np.allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(ranks, arch):
    want = float(np.load(REFERENCE)[f"{arch}/loss"])
    for r in ranks:
        assert abs(r[arch]["loss"][1] - want) <= REF_LOSS_RTOL[arch] * \
            abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(ranks, arch):
    z = np.load(REFERENCE)
    keys = {k[len(f"{arch}/grad"):] for k in z.files
            if k.startswith(f"{arch}/grad")}
    for r in ranks:
        assert r[arch]["grads"].keys() == keys
        errs = _ref_errors(r[arch], arch)
        assert max(errs.values()) <= REF_GRAD_L2[arch], errs


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_one_device(ranks, arch):
    for r in ranks:
        seq, got = r[arch]["loss"]
        assert abs(got - seq) <= LOSS_RTOL * abs(seq)
    assert len({r[arch]["loss"][1] for r in ranks}) == 1


def test_dense_grads_match_one_device(ranks):
    for r in ranks:
        assert _grad_errors(r["granite-8b"]) == []


def test_hybrid_layer_on_a_width_split_matches_in_f32(ranks):
    for r in ranks:
        rec = r["hybrid_layer_f32"]
        a, b = rec["loss"]
        assert abs(a - b) <= F32_LOSS_RTOL * abs(a)
        for k, (g0, g1) in rec["grads"].items():
            assert float((g0 - g1).abs().max()) <= \
                F32_GRAD_REL * float(g0.abs().max()), k


@pytest.mark.parametrize("arch", ARCHS)
def test_hand_offs_are_collective_permutes(ranks, arch):
    for r in ranks:
        perms = [c for c in r[arch]["calls"] if c[0] == "collective-permute"]
        assert perms == [("collective-permute", float(BOUNDARY_BYTES), 2,
                          1)] * HAND_OFFS
        assert not [c for c in r[arch]["calls"] if c[0] == "all-to-all"]


def test_planted_hand_off_fault_is_caught(faulty):
    assert all(_grad_errors(r["granite-8b"]) for r in faulty)
    for arch in ARCHS:
        for r in faulty:
            errs = _ref_errors(r[arch], arch)
            assert max(errs.values()) > 2 * REF_GRAD_L2[arch], (arch, errs)


def readings(tmp) -> None:
    """Print the readings the limits are set from (module docstring)."""
    got = torch_dist.run("pipeline_dtensor", 4, tmp / "pp")
    bad = torch_dist.run("pipeline_dtensor", 4, tmp / "ppf",
                         fault="handoff_backward")
    z = np.load(REFERENCE)
    for arch in ARCHS:
        want = float(z[f"{arch}/loss"])
        print(arch, "loss rel",
              max(abs(r[arch]["loss"][1] - want) / abs(want) for r in got),
              "| gradient L2: pipeline",
              max(max(_ref_errors(r[arch], arch).values()) for r in got),
              "one-device",
              max(_ref_errors(got[0][arch], arch, which=0).values()),
              "planted fault",
              min(max(_ref_errors(r[arch], arch).values()) for r in bad))


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        readings(pathlib.Path(d))
