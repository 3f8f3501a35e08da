"""Sharding rules: parameter/activation PartitionSpecs per mesh
(counterpart of ``repro/sharding/specs.py``), and their placements on a
``DeviceMesh``.

Axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Batch is sharded over DP = (pod, data); tensor parallelism over
"model"; with ``fsdp=True`` parameters and optimizer state are additionally
sharded over "data" (ZeRO-3-style).

MoE experts carry the "model" axis when the expert count divides it
(expert parallelism); otherwise the ffn dimension does (TP-within-expert).

The rules are the reference's, over the same ``keystr`` paths
(``['layers']['attn']['wq']``), so that the same strings meet the same
regexes.  Spec trees are taken over anything with a ``.shape`` (meta
tensors, ``torch.empty(shape, device="meta")``, are the port's
``ShapeDtypeStruct``); a mesh is a ``DeviceMesh`` or any object with the
reference's ``.shape`` dict.  ``named`` turns a spec tree into the DTensor
placements of each leaf and ``distribute`` places a tree of tensors by
them: together they are what ``jax.device_put(x, NamedSharding(mesh,
spec))`` is to the reference.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_names, axis_sizes


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, each ``None``, a mesh
    axis name, or a tuple of them (the dim split over several axes, the
    first major).  As ``jax.sharding.PartitionSpec`` does, a one-axis
    tuple is kept as the bare name and an empty one as ``None``."""

    def __new__(cls, *parts):
        def norm(p):
            if isinstance(p, tuple) and len(p) <= 1:
                return p[0] if p else None
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts / NamedTuples (a ``P`` is a
    leaf), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, k),
                                     *(getattr(r, k) for r in rest))
                            for k in tree._fields))
    return fn(tree, *rest)


def _paths_map(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _paths_map(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree)


def meta(tree: dict) -> dict:
    """A dict of ``(shape, dtype)`` pairs (``Model.input_specs``) as meta
    tensors."""
    return {k: torch.empty(s, dtype=d, device="meta")
            for k, (s, d) in tree.items()}


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    fsdp: bool = True             # shard params/opt-state over "data"
    ep: bool = True               # expert parallelism when divisible
    tp: bool = True               # tensor parallelism over "model"
                                  # (False = pure DP: right for tiny models)
    shard_vocab: bool = True      # vocab-shard the (un)embedding
    seq_shard_decode: bool = False  # shard KV cache sequence dim (SP)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def sanitize(pspec: P, shape, mesh) -> P:
    """Drop mesh axes from dims they do not divide (replicate instead),
    as the reference does: odd head counts (36, 25) or vocab sizes would
    otherwise not shard evenly."""
    sizes = axis_sizes(mesh)
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    fixed = []
    for dim, axes in zip(shape, parts):
        if axes is None:
            fixed.append(None)
            continue
        ax = axes if isinstance(axes, tuple) else (axes,)
        size = math.prod(sizes[a] for a in ax)
        fixed.append(axes if dim % size == 0 else None)
    return P(*fixed)


def _f(sc: ShardingConfig) -> Optional[str]:
    return "data" if sc.fsdp else None


def param_pspecs(cfg: ModelConfig, specs, mesh,
                 sc: ShardingConfig = ShardingConfig()):
    """Map the parameter tree (anything with ``.shape``) to PartitionSpecs
    by path rules."""
    model_sz = axis_sizes(mesh)["model"]
    fs = _f(sc)
    use_ep = sc.ep and cfg.n_experts and cfg.n_experts % model_sz == 0

    def rule(path: str, s) -> P:
        r = len(s.shape)  # includes the leading layer-stack dim for "layers"
        stacked = path.startswith("['layers']") \
            or path.startswith("['enc_layers']")

        def pad(spec_tail):  # prepend None for the stacked layer dim
            return P(*(((None,) if stacked else ()) + spec_tail))

        if "embed" in path or "unembed" in path:
            return P("model" if sc.shard_vocab else None, fs)
        if re.search(r"\['(ln1|ln2|ln_f|ln_x|ln_ssm|enc_ln_f)'\]", path):
            return pad((None,))
        if "a_log" in path or "dt_bias" in path or "d_skip" in path \
                or "norm_w" in path:
            return pad((None,))
        if "patch_proj" in path:
            return P(None, None)
        if "router" in path:
            return pad((fs, None))
        if re.search(r"\['ffn'\]\['w_(in|gate)'\]", path) and cfg.n_experts:
            return pad(("model", fs, None) if use_ep else (None, fs, "model"))
        if re.search(r"\['ffn'\]\['w_out'\]", path) and cfg.n_experts:
            return pad(("model", None, fs) if use_ep else (None, "model", fs))
        if re.search(r"\['w_(in|gate)'\]", path):
            return pad((fs, "model"))
        if re.search(r"\['w_out'\]", path) and "ssm" not in path:
            return pad(("model", fs))
        if re.search(r"\['(wq|wk|wv)'\]", path):
            return pad((fs, "model"))
        if re.search(r"\['wo'\]", path):
            return pad(("model", fs))
        # ssm
        if "w_xz" in path:
            return pad((fs, "model"))
        if "w_bc" in path or "w_dt" in path:
            return pad((fs, None))
        if re.search(r"\['ssm'\]\['w_out'\]", path):
            return pad(("model", fs))
        return P(*([None] * r))

    def detp(spec: P) -> P:
        if sc.tp:
            return spec
        return P(*[None if a == "model" else a for a in tuple(spec)])

    return _paths_map(
        lambda p, s: sanitize(detp(rule(p, s)), s.shape, mesh), specs)


def batch_pspecs(specs, mesh):
    dp = dp_axes(mesh)

    def rule(path, s):
        if len(s.shape) == 0:
            return P()
        return P(dp, *([None] * (len(s.shape) - 1)))

    return _paths_map(lambda p, s: sanitize(rule(p, s), s.shape, mesh),
                      specs)


def cache_pspecs(cfg: ModelConfig, specs, mesh,
                 sc: ShardingConfig = ShardingConfig()):
    """Decode caches: [L, B, S, Hkv, hd] kv + [L, B, H, P, N] ssm state.
    Batch over DP; kv heads (or the sequence, with SP) over model."""
    dp = dp_axes(mesh)

    def rule(path, s):
        if "ssm" in path:
            return P(None, dp, "model", None, None)
        if sc.seq_shard_decode:               # SP: shard the sequence dim
            return P(None, dp, "model", None, None)
        # kv-head counts are often not divisible by the model axis (4, 5,
        # 8 vs 16): shard head_dim instead — always a multiple of 16
        return P(None, dp, None, None, "model")

    return _paths_map(lambda p, s: sanitize(rule(p, s), s.shape, mesh),
                      specs)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that names the axis, else
    ``Replicate()``.  A tensor dim split over several axes is sharded by
    DTensor in mesh-dim order, the earlier dim major; the spec's order of
    those axes must be the mesh's (``("pod", "data")``), which is JAX's
    major-to-minor order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        ax = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in ax]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {ax} of dim {d} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def named(tree, mesh):
    """A spec tree as a tree of ``NamedSharding``s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), tree)


def distribute(tree, pspecs, mesh):
    """A tree of (global) tensors placed on ``mesh`` by ``pspecs``: each
    leaf becomes a DTensor whose local shard on this rank is its block of
    the global tensor.  Every rank must pass the same global values."""
    from torch.distributed.tensor import distribute_tensor
    dev = mesh.device_type

    def one(x, spec):
        return distribute_tensor(x.to(dev), mesh, placements(spec, mesh))

    return tree_map(one, tree, pspecs)


def constrain(x, spec):
    """Pin a tensor's sharding (the reference's
    ``with_sharding_constraint``): identity with no spec or on a plain
    tensor (one device, as the reference is with no mesh); a DTensor is
    redistributed to the spec's placements on its own mesh."""
    from torch.distributed.tensor import DTensor
    if spec is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def shard_offset(t, dim: int) -> int:
    """This rank's first global index along ``dim`` of a DTensor (0 for a
    plain tensor): DTensor's ``torch.chunk`` layout, mesh dims in order,
    the earlier one major."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return 0
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    length, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            c = -(-length // mesh.size(i))
            off += coord[i] * c
            length = max(0, min(c, length - coord[i] * c))
    return off


def as_placed(local, mesh, placements, shape):
    """``local``, this rank's shard, as a DTensor of global ``shape``
    placed by ``placements`` on ``mesh``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= max(d, 1)
    return DTensor.from_local(local.contiguous(), mesh, tuple(placements),
                              run_check=False, shape=shape,
                              stride=tuple(reversed(stride)))


def with_placements(t, fn):
    """A DTensor redistributed to ``fn(i, placement)`` on each mesh dim
    ``i`` (itself when nothing changes)."""
    pl = [fn(i, p) for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else \
        t.redistribute(t.device_mesh, pl)
