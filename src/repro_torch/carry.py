"""Carry simulator state across the JAX reference and the port.

The reference's ``SimStatic``/``SimState`` are NamedTuples of arrays; the
port's have the same leaf names, shapes and dtypes.  Given as
``{name: np.ndarray}`` (for example ``{k: np.asarray(v) for k, v in
jax_state._asdict().items()}``), they become the port's tuples on a
device, and back.  This is the simulator's counterpart of loading
weights: a test can start both engines from one state, a mid-run one
included.  Every leaf carries, the closed-loop memory leaves (``rdy``,
``dead``, ``outst``, ``bank_*``, ``amat_*``, ``mem_*``) and the trace
leaves (``cur_phase``, ``phase_*``, ``mc_id``) and the lossy-PHY and
living-channel leaves too; a state made with ``mem_on``, ``phy_on`` or a
living flag must run in the port with the same flags
(``simulator.run_from``, ``run_cycles``).  A carried ``phy_seed`` keeps
the reference's uint32 (``pack`` holds it in int64); the step reads
either.

For the model side, ``params_from_jax`` turns the reference's parameter
tree (leaves as numpy arrays) into the port's, and ``numpy_params`` makes
a parameter tree from a seed with the reference's distributions, so that
both packages can be fed the same weights without JAX on the card;
``opt_state_from_numpy``/``opt_state_to_numpy`` carry the optimizer's
state (the reference's ``AdamWState(step, m, v)``), so that both packages
can continue one mid-run ``(params, opt_state)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.simulator import SimState, SimStatic
from repro_torch.models import transformer as tf


def _tensors(cls, fields: dict, device):
    missing = set(cls._fields) - set(fields)
    extra = set(fields) - set(cls._fields)
    if missing or extra:
        raise ValueError(f"{cls.__name__} fields: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    dev = _device.resolve(device)
    return cls(**{k: torch.from_numpy(np.array(fields[k], copy=True)).to(dev)
                  for k in cls._fields})


def static_from_numpy(fields: dict, device=None) -> SimStatic:
    """``{name: array}`` -> the port's ``SimStatic`` on ``device``."""
    return _tensors(SimStatic, fields, device)


def state_from_numpy(fields: dict, device=None) -> SimState:
    """``{name: array}`` -> the port's ``SimState`` on ``device``."""
    return _tensors(SimState, fields, device)


def state_to_numpy(st) -> dict:
    """A port ``SimState`` (or ``SimStatic``) -> ``{name: np.ndarray}``."""
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def _leaf_to_torch(a: np.ndarray, dev, f32: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":              # ml_dtypes' bf16, from JAX
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
        t = t.view(torch.bfloat16)
        return t.to(dev, torch.float32) if f32 else t.to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(
        dev, torch.float32 if f32 else torch.bfloat16)


def params_from_jax(tree: dict, device=None, _path: str = "") -> dict:
    """The reference's parameter tree (a nested dict whose leaves are numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) -> the port's
    parameters on ``device``: bf16 (the reference's ``param_dtype``), but
    f32 for the leaves the reference declares f32 whatever that dtype
    (the SSM's ``a_log``, ``dt_bias``, ``d_skip``).  bf16 leaves keep their
    bits; other leaves are rounded to bf16, or kept f32."""
    dev = _device.resolve(device)
    out = {}
    for k, v in tree.items():
        path = f"{_path}[{k!r}]"
        out[k] = params_from_jax(v, dev, path) if isinstance(v, dict) \
            else _leaf_to_torch(v, dev, tf.is_f32_leaf(path))
    return out


def round_bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 value (ties to even), kept as
    f32 (finite inputs; rounds in place when given an f32 array)."""
    b = np.asarray(a, dtype=np.float32).view(np.uint32)
    b += np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))
    b &= np.uint32(0xFFFF0000)
    return b.view(np.float32)


BLOCK = 1 << 24           # values per independently seeded block
BLOCKED = 1 << 28         # leaves larger than this are drawn in blocks


def _draw_blocked(seed: int, leaf: int, shape, std: float,
                  rounded: bool) -> np.ndarray:
    """N(0, 1) * std (rounded to bf16 values, as f32, if ``rounded``),
    block ``i`` of ``BLOCK`` values drawn from ``default_rng([seed, leaf,
    i])``, the blocks on threads (numpy's generators release the GIL
    while they fill)."""
    from concurrent.futures import ThreadPoolExecutor
    out = np.empty(shape, np.float32)
    flat = out.reshape(-1)

    def fill(i: int) -> None:
        part = flat[i * BLOCK:(i + 1) * BLOCK]
        np.random.default_rng([seed, leaf, i]).standard_normal(
            dtype=np.float32, out=part)
        part *= np.float32(std)
        if rounded:
            round_bf16(part)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(fill, range(-(-flat.size // BLOCK))))
    return out


def numpy_params(cfg, seed: int, *, ones_jitter: float = 0.0,
                 leaf_fn=None, rounded: bool = True) -> dict:
    """A parameter tree for ``cfg`` from ``np.random.default_rng(seed)``
    with the distributions of the reference's ``init_params``: norm
    weights 1, biases 0, matrices N(0, 1) * fan_in^-0.5 in f32, rounded to
    bf16 (ties to even); the SSM's ``a_log`` = log U(1, 16), ``dt_bias`` 0,
    ``d_skip`` 1.  Leaves are f32 arrays.  Those the reference keeps in f32
    (``tf.is_f32_leaf``) are not rounded; the others hold bf16 values, so
    either package casts them to bf16 exactly.  The leaves are drawn in
    JAX's flattening order; a matrix of more than ``BLOCKED`` values (an
    expert stack at full width) is drawn in blocks from seeds of its own
    (``_draw_blocked``), so that it takes seconds, not minutes.

    ``ones_jitter``: the leaves the reference fills with ones (norm
    weights, the SSM's ``norm_w`` and ``d_skip``) are drawn as
    1 + ones_jitter * N(0, 1) instead (bf16 values unless f32 leaves), so
    that two norms of one layer differ and a check can tell them apart.
    ``leaf_fn(name, array)``: applied to each leaf as soon as it is drawn
    (a cast, a copy to a device), so that a large tree is never held whole
    in f32.  ``rounded=False`` leaves the bf16 leaves unrounded, for a
    ``leaf_fn`` that casts them to bf16 itself (round to nearest even, the
    same values; ``leaf_to_device`` does)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (name, shape) in enumerate(tf.leaves(tf.param_shapes(cfg))):
        kind, val = tf.init_rule(name, shape)
        if kind == "fill" and val == 1.0 and ones_jitter:
            a = 1.0 + np.float32(ones_jitter) * rng.standard_normal(
                shape, dtype=np.float32)
            a = a if tf.is_f32_leaf(name) or not rounded else round_bf16(a)
        elif kind == "fill":
            a = np.full(shape, val, np.float32)
        elif kind == "log_uniform":
            a = np.log(rng.uniform(*val, shape)).astype(np.float32)
        elif int(np.prod(shape)) > BLOCKED:
            a = _draw_blocked(seed, i, shape, val, rounded)
        else:
            a = rng.standard_normal(shape, dtype=np.float32)
            a *= np.float32(val)
            a = round_bf16(a) if rounded else a
        out.append((name, a if leaf_fn is None else leaf_fn(name, a)))
    return tf.unflatten(out)


def leaf_to_device(name: str, a: np.ndarray, device=None) -> torch.Tensor:
    """One ``numpy_params`` leaf as the port's parameter on ``device`` (a
    ``leaf_fn``): f32 for the leaves the reference keeps in f32, else cast
    to bf16 (round to nearest even) on the host, then moved."""
    dev = _device.resolve(device)
    t = torch.from_numpy(a)
    return (t if tf.is_f32_leaf(name) else t.to(torch.bfloat16)).to(dev)


def _tree_to_device(tree: dict, dev) -> dict:
    return {k: _tree_to_device(v, dev) if isinstance(v, dict) else
            torch.from_numpy(np.array(v, dtype=np.float32, copy=True)).to(dev)
            for k, v in tree.items()}


def opt_state_from_numpy(step, m: dict, v: dict, device=None):
    """The reference's ``AdamWState(step, m, v)`` as numpy (``step`` an int
    or a 0-d array, ``m`` and ``v`` parameter-shaped trees of f32 arrays)
    -> the port's ``AdamWState`` on ``device`` (``step`` a Python int, the
    moments f32 tensors), so that both packages can continue one mid-run
    state."""
    from repro_torch.train.optimizer import AdamWState
    dev = _device.resolve(device)
    return AdamWState(step=int(step), m=_tree_to_device(m, dev),
                      v=_tree_to_device(v, dev))


def opt_state_to_numpy(state) -> tuple:
    """A port ``AdamWState`` -> ``(step, m, v)``: an int and two trees of
    f32 numpy arrays, the reference's ``AdamWState`` fields."""
    def host(tree):
        return {k: host(x) if isinstance(x, dict) else
                x.detach().float().cpu().numpy() for k, x in tree.items()}
    return int(state.step), host(state.m), host(state.v)
