"""The dry run's DTensor paths with real values: what ``launch/dryrun.py``
runs on a fake group computes, on real ranks, what the one-device port
computes.  Four gloo ranks on a (2, 2) ("data", "model") mesh
(``torch_dist.sharded_ops``, ``torch_dist.sharded_paths``):

- Each path on its own in f32 (``layers.dot`` in its FSDP, row-parallel
  and expert-parallel placements; ``attention.inner_on_shards`` with q's
  heads split and with q's sequence split, causal, windowed and not;
  ``ssm.ssd_on_shards`` and its state, ``ssm.recur_on_shards``;
  ``transformer.embed_on_shards`` with the vocabulary split;
  ``moe.moe_on_shards`` with two groups and one; ``attention.write_cache``
  and decode's two products against a cache split on its sequence or
  head dim): the result and every input's gradient equal the plain
  version's within ``OP_TOL`` of the largest entry (f32 sums in another
  order).
- Whole smoke models in bf16, built and placed as the dry run builds them
  (granite-8b, hymba-1.5b, mixtral-8x22b, mamba2-1.3b, whisper-tiny, and
  granite-8b with q's sequence split): the loss, every gradient, a
  2-microbatch train step's loss and two decode steps (a 0-d position,
  the cache split on its sequence, then on its head dim) against the
  one-device port with the same MoE dispatch groups, within
  ``MODEL_TOL``: bf16 products summed in other orders (measured: loss
  2.6e-4, gradients 6.3e-2 in relative L2, logits 3.5e-2 of the
  largest).
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_dist  # noqa: E402

OP_TOL = 1e-5
MODEL_TOL = dict(loss=1e-3, grad=0.1, logits=5e-2, cache=2e-2)
OPS = ["dot/fsdp+tp", "dot/row", "dot/experts", "attention/heads",
       "attention/seq", "attention/seq/bidirectional", "ssd", "ssd/state",
       "ssd/decode", "embed", "moe/groups", "moe/one group",
       "write_cache/seq", "write_cache/hd",
       "decode_einsum/bqhgd,bshd->bhgqs/seq",
       "decode_einsum/bqhgd,bshd->bhgqs/hd",
       "decode_einsum/bhgqs,bshd->bqhgd/seq",
       "decode_einsum/bhgqs,bshd->bqhgd/hd"]
MODELS = list(torch_dist.SHARDED_ARCHS) + ["granite-8b/sp"]


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    return torch_dist.run("sharded_ops", 4, tmp_path_factory.mktemp("ops"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return torch_dist.run("sharded_paths", 4,
                          tmp_path_factory.mktemp("paths"))


def _rel_max(a, b) -> float:
    return float((b - a).abs().max() / a.abs().max().clamp(min=1e-30))


def _rel_l2(a, b) -> float:
    return float((b - a).norm() / a.norm().clamp(min=1e-30))


@pytest.mark.parametrize("name", OPS)
def test_sharded_op_matches_plain(ops, name):
    for rank in ops:                  # every rank gathers the same result
        rec = rank[name]
        assert "out" in rec
        for part, (plain, sharded) in rec.items():
            assert plain.shape == sharded.shape, (part, plain.shape)
            assert _rel_max(plain, sharded) <= OP_TOL, part
    assert set(ops[0]) == set(OPS)


@pytest.mark.parametrize("name", MODELS)
def test_sharded_model_matches_plain(models, name):
    rec = models[0][name]
    loss, dloss = rec["loss"]
    assert abs(dloss - loss) <= MODEL_TOL["loss"] * abs(loss)
    loss, dloss = rec["micro_loss"]
    assert abs(dloss - loss) <= MODEL_TOL["loss"] * abs(loss)
    for leaf, (g, dg) in rec["grads"].items():
        assert _rel_l2(g, dg) <= MODEL_TOL["grad"], leaf
    for tag in ("", "/hd"):           # the cache split on S, then on hd
        for lg, dlg in rec.get("decode_logits" + tag, []):
            assert _rel_max(lg, dlg) <= MODEL_TOL["logits"], tag
        for k, (c, dc) in rec.get("decode_cache" + tag, {}).items():
            assert _rel_max(c, dc) <= MODEL_TOL["cache"], (tag, k)
        assert ("decode_logits" + tag in rec) == \
            (not name.startswith("whisper"))


def test_a_wrong_gradient_placement_is_caught(tmp_path):
    """A planted fault: every shard's gradient declared whole
    (``to_local``'s ``grad_placements`` dropped), so that k's and v's
    gradients in ``inner_on_shards`` with q's sequence split, each rank's
    a partial sum, are taken for the whole: the op check must fail."""
    res = torch_dist.run("sharded_ops", 4, tmp_path,
                         fault="replicated_kv_grads")
    rec = res[0]["attention/seq"]
    worst = max(_rel_max(a, b) for part, (a, b) in rec.items()
                if part != "out")
    assert worst > 1e-2
