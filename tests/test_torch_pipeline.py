"""The port's GPipe pipeline (``train/pipeline.py``) on gloo ranks against
the port's sequential ``Model.loss`` and the JAX package's pipeline.

Two cases (``torch_dist.pipeline``, the cases of ``dist_reference.npz``):
granite-8b smoke, 2 stages x 2 microbatches on a (2, 2) ("data",
"model") mesh (two pipelines side by side), ``remat="none"``; and
hymba-1.5b smoke cut to 4 layers, 4 stages x 4 microbatches on (1, 4),
``remat="full"``.  Tolerances, with their reasons:

- against the port's sequential ``Model.loss`` on the same weights and
  batch: the loss to rel 1e-6 (each layer runs the same operations on a
  microbatch's rows, and the f32 stage boundaries hold bf16 values
  exactly; measured: equal), the gradients to 2^-6 of each leaf's largest
  entry (autograd adds a bf16 leaf's per-microbatch gradients in bf16, one
  rounding each, where the sequential backward rounds once; measured: one
  bf16 ulp of the largest entry);
- against the reference's pipeline (compiled, on 2 and 4 host devices):
  the reference's own bound between its pipeline and its sequential loss
  (``tests/test_pipeline.py``: loss rel 2e-2, gradients rtol 0.15 and atol
  0.02);
- every rank's loss and gradients are the same (the whole tree's
  gradient is gathered onto each rank, as the reference's is global).

A planted fault, the hand-off's backward dropped, must be caught.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import pipeline as jpp  # noqa: E402
from repro_torch.train import pipeline as pp  # noqa: E402

import torch_dist  # noqa: E402

CASES = ["granite", "hybrid"]
SEQ_LOSS_RTOL = 1e-6
SEQ_GRAD_REL = 2.0 ** -6            # of each leaf's largest entry
REF_LOSS_RTOL, REF_RTOL, REF_ATOL = 2e-2, 0.15, 0.02


def test_regroup_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((8, 3, 2)).astype(np.float32),
            "b": {"c": rng.standard_normal((8, 5)).astype(np.float32)}}
    want = jpp._regroup(jax.tree.map(jnp.asarray, tree), 4)
    got = pp._regroup({"a": torch.from_numpy(tree["a"]),
                       "b": {"c": torch.from_numpy(tree["b"]["c"])}}, 4)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
    with pytest.raises(ValueError, match="stages"):
        pp._regroup(got, 3)


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pp.make_pp_loss(None, None, n_stages=2, n_micro=2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist.run("pipeline", 4, tmp_path_factory.mktemp("pp"))


@pytest.fixture(scope="module")
def faulty(tmp_path_factory):
    return torch_dist.run("pipeline", 4, tmp_path_factory.mktemp("ppf"),
                          fault="handoff_backward")


def seq_errors(rec: dict, seq: dict) -> dict:
    """Each gradient leaf's largest difference over its largest entry."""
    return {k: float((g - seq[k]).abs().max() / seq[k].abs().max())
            for k, g in rec["grads"].items()}


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_equal_sequential(ranks, case):
    seq = ranks[0][case]
    for rank, r in enumerate(ranks):
        rec = r[case]
        np.testing.assert_allclose(rec["loss"], seq["seq_loss"],
                                   rtol=SEQ_LOSS_RTOL)
        errs = seq_errors(rec, seq["seq_grads"])
        assert max(errs.values()) <= SEQ_GRAD_REL, (rank, errs)
        for k, g in rec["grads"].items():        # replicated
            assert torch.equal(g, seq["grads"][k]), (rank, k)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grads_match_reference_pipeline(ranks, case):
    z, meta = torch_dist.fixture()
    want = meta["pp"][case]
    rec = ranks[0][case]
    np.testing.assert_allclose(rec["loss"], want["loss"], rtol=REF_LOSS_RTOL)
    assert rec["grads"].keys() == {k[len(f"pp/{case}/grad"):] for k in
                                   z.files if k.startswith(
                                       f"pp/{case}/grad")}
    for k, g in rec["grads"].items():
        np.testing.assert_allclose(g.numpy(), z[f"pp/{case}/grad{k}"],
                                   rtol=REF_RTOL, atol=REF_ATOL, err_msg=k)


def test_dropped_handoff_backward_is_rejected(ranks, faulty):
    """Without the reverse hand-off, no stage but the last gets the
    gradient of its output: its layers' gradients are wrong, the loss is
    not."""
    for case in CASES:
        seq = ranks[0][case]["seq_grads"]
        bad = faulty[0][case]
        assert bad["loss"] == ranks[0][case]["loss"]
        errs = seq_errors(bad, seq)
        assert max(errs.values()) > SEQ_GRAD_REL, (case, errs)
        assert max(v for k, v in errs.items() if "layers" in k) > 0.5
