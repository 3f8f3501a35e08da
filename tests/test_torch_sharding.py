"""The port's meshes and sharding (``launch/mesh.py``, ``sharding/specs.py``,
the sharding fields of ``Model``, ``AdamW.init_specs``/``state_pspecs``,
``CheckpointManager.restore(shardings=)`` and the two-level all-reduce of
``interconnect/scheduler.py``) against the JAX package.

- Spec trees: every leaf's PartitionSpec equals the reference's, for all
  ten configs on both production meshes ((16, 16) and (2, 16, 16)) under
  six ``ShardingConfig`` variants.  The reference side takes a fake mesh
  object (a ``shape`` dict, as its own test passes); the port side builds
  real ``DeviceMesh``es under a fake process group of 512 ranks, in a
  subprocess (``torch_dist.production_specs``).
- Shards: on four gloo ranks, every leaf of the hymba-1.5b and
  mixtral-8x22b smoke params, batch and cache, placed by its spec on a
  (2, 2) ("data", "model") and a (2, 2, 1) ("pod", "data", "model") mesh,
  holds on rank r exactly the block that ``NamedSharding.
  devices_indices_map`` gives JAX's device r (``dist_reference.npz``).
  A planted fault, the pod and data axes swapped in the rank layout (a dim
  split over ("pod", "data") laid out data-major), must be caught.
- Exact comparisons throughout: specs are data, shards are copies.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.sharding import specs as jsh  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.checkpoint.checkpoint import leaf_paths  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import specs as sh  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

import torch_dist  # noqa: E402

ARCHS = sorted(jbase.all_configs())
ROOT = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """The reference's mesh interface without devices."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


PRODUCTION = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(k): torch_dist.spec_list(v) for k, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _ref_trees(arch, multi, sc_kw) -> dict:
    cfg = jbase.get_config(arch)
    mesh = FakeMesh(PRODUCTION[multi])
    sc = jsh.ShardingConfig(**sc_kw)
    model = JModel(cfg)
    dec = jbase.SHAPES["decode_32k"]
    out = {"params": jsh.param_pspecs(cfg, model.param_specs(), mesh, sc),
           "cache": jsh.cache_pspecs(cfg, model.decode_state_specs(
               dec.global_batch, dec.seq_len), mesh, sc)}
    for shp in ("train_4k", "decode_32k"):
        out[f"batch/{shp}"] = jsh.batch_pspecs(
            model.input_specs(jbase.SHAPES[shp]), mesh)
    return {k: _jflat(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "production.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "torch_dist.py"),
                          "production_specs", str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference_on_production_meshes(production, arch):
    checked = 0
    for multi in (False, True):
        for vname, kw in torch_dist.SC_VARIANTS.items():
            got = production[f"{int(multi)}/{arch}/{vname}"]
            want = _ref_trees(arch, multi, kw)
            assert got.keys() == want.keys()
            for t in want:
                assert got[t] == want[t], (multi, vname, t)
                checked += len(want[t])
    assert checked > 100


def test_partition_spec_normalizes_like_jax():
    cases = [(), (None,), ("data",), (("data",), None), (("pod", "data"),),
             ("model", ("pod", "data"), None), ((), "model")]
    for c in cases:
        assert tuple(sh.P(*c)) == tuple(JP(*c)), c


def test_sanitize_drops_nondivisible_axes():
    """The reference's own cases (``tests/test_interconnect.py``), and the
    reference's result on every spec of a small grid of shapes."""
    fm = FakeMesh({"data": 16, "model": 16})
    assert sh.sanitize(sh.P("model", "data"), (25, 32), fm) \
        == sh.P(None, "data")
    assert sh.sanitize(sh.P(("data", "model"), None), (256, 7), fm) \
        == sh.P(("data", "model"), None)
    pm = FakeMesh({"pod": 2, "data": 4, "model": 8})
    specs = [("model", "data"), (("pod", "data"), None, "model"),
             (None, ("data", "model")), ("pod",), ()]
    for spec in specs:
        for shape in [(8, 8, 8), (2, 6, 32), (16, 3, 4), (64, 64, 1)]:
            want = jsh.sanitize(JP(*spec), shape, pm)
            assert tuple(sh.sanitize(sh.P(*spec), shape, pm)) \
                == tuple(want), (spec, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_specs_are_the_references_shapes(arch):
    """``Model.param_specs``, ``decode_state_specs`` and
    ``AdamW.init_specs`` (meta tensors) against the reference's
    ``ShapeDtypeStruct``s: paths, shapes and dtypes; ``state_pspecs``
    against the reference's tree."""
    jcfg, cfg = jbase.get_config(arch), base.get_config(arch)

    def jshapes(tree):
        return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def tshapes(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in leaf_paths(tree)}

    jm, tm = JModel(jcfg), Model(cfg)
    ps = tm.param_specs()
    assert all(v.is_meta for _, v in tf.leaves(ps))
    assert tshapes(ps) == jshapes(jm.param_specs())
    if jcfg.family != "encdec":
        assert tshapes(tm.decode_state_specs(8, 64)) \
            == jshapes(jm.decode_state_specs(8, 64))
    want = jshapes(JAdamW().init_specs(jm.param_specs()))
    got = tshapes(AdamW().init_specs(ps))
    assert got == want
    fm = FakeMesh(PRODUCTION[True])
    jp = jsh.param_pspecs(jcfg, jm.param_specs(), fm)
    tp = sh.param_pspecs(cfg, ps, fm)
    st = AdamW().state_pspecs(tp)
    got = {".step": torch_dist.spec_list(st.step)}
    for f in ("m", "v"):
        got.update({f".{f}{k}": torch_dist.spec_list(v)
                    for k, v in tf.leaves(getattr(st, f))})
    assert _jflat(JAdamW().state_pspecs(jp)) == got


def test_constrain_is_identity_on_plain_tensors():
    x = torch.randn(4, 8)
    assert sh.constrain(x, sh.P("data", None)) is x
    assert sh.constrain(x, None) is x


@pytest.mark.parametrize("name", ["hymba-1.5b", "mixtral-8x22b"])
def test_sharding_fields_leave_one_device_bitwise_unchanged(name):
    """With every sharding field set (one MoE dispatch group), a model on
    plain tensors computes the same loss and decode logits, bit for bit,
    as with none: the constraints are identities off a mesh, as the
    reference's are."""
    from repro_torch import carry
    cfg = base.get_config(name).smoke()
    params = carry.params_from_jax(carry.numpy_params(cfg, 0), device="cpu")
    dp = sh.P("data", None, None)
    specs = dict(act_spec=dp,
                 sp_specs=(sh.P("data", "model", None, None),
                           sh.P("data", None, None, None)),
                 moe_specs=(sh.P(None, "model", None, None), dp, 1),
                 fsdp_gather_specs=sh.tree_map(
                     lambda s: sh.P(*([None] * (len(s) - 1))),
                     tf.layer_shapes(cfg)))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    plain, pinned = Model(cfg, xent_chunk=16), Model(cfg, xent_chunk=16,
                                                     **specs)
    assert torch.equal(plain.loss(params, batch), pinned.loss(params, batch))
    ca, cb = (m.init_decode_state(2, 8, device="cpu") for m in (plain,
                                                                 pinned))
    la, _ = plain.decode(params, ca, toks[:, :1], 0)
    lb, _ = pinned.decode(params, cb, toks[:, :1], 0)
    assert torch.equal(la, lb)


def test_meshes_need_a_process_group_and_a_card():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh((1, 1), ("data", "model"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.init_distributed()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    return torch_dist.run("sharding", 4, tmp, ckpt_dir=str(tmp / "ckpt"))


def test_mesh_layout_is_jax_device_order(ranks):
    """``make_mesh`` puts rank r where ``jax.make_mesh`` put device r."""
    for r in ranks:
        assert r["layout/dm"] and r["layout/pdm"]


@pytest.mark.parametrize("mesh", ["dm", "pdm"])
def test_every_rank_shard_equals_reference(ranks, mesh):
    _, meta = torch_dist.fixture()
    want_n = sum(len(t) for a in meta["specs"][mesh]["archs"].values()
                 for t in a.values())
    for rank, r in enumerate(ranks):
        bad_spec, bad_shard, n = r[f"shards/{mesh}"]
        assert n == want_n and n > 30
        assert bad_spec == [], (rank, bad_spec)
        assert bad_shard == [], (rank, bad_shard)


def test_swapped_pod_data_order_is_rejected(ranks):
    """The planted fault moves the blocks of every ("pod", "data") dim on
    the two ranks whose pod and data coordinates differ."""
    bad = {rank: r["shards/pdm swapped"][1] for rank, r in enumerate(ranks)}
    n = ranks[0]["shards/pdm swapped"][2]
    assert n >= 6
    assert bad[0] == [] and bad[3] == []
    assert len(bad[1]) == len(bad[2]) == n


def test_constrain_redistributes_dtensors(ranks):
    x = torch.arange(32.0).reshape(4, 8)
    for rank, r in enumerate(ranks):
        c = r["constrain"]
        assert c["is_dtensor"] and c["full_equal"]
        assert c["placements"] == c["want"]
        col = rank % 2                           # the "model" coordinate
        assert torch.equal(c["local"], x[:, 4 * col:4 * col + 4])
        assert c["none_is_identity"] and c["plain_is_identity"]


def test_restore_with_shardings_places_and_gathers_back(ranks):
    for r in ranks:
        rs = r["restore"]
        assert rs["bad_gather"] == [] and rs["bad_local"] == []
        assert rs["leaves"] == 20 and rs["sharded_leaves"] >= 10


def test_hierarchical_psum_equals_one_flat_all_reduce(ranks):
    for r in ranks:
        assert r["hier"] == {"equal_flat": True, "equal_sum": True,
                             "tree_equal": True, "input_kept": True}


def test_meshes_need_enough_ranks(ranks):
    for r in ranks:
        assert r["mesh_errors"]["production"].startswith(
            "need 256 devices, have 4")
        assert r["mesh_errors"]["multi_pod"].startswith(
            "need 512 devices, have 4")
        assert r["host_mesh"] == {"data": 1, "model": 1}
