"""Checkpoints with integrity checks and async save (counterpart of
``repro/checkpoint/checkpoint.py``), in the reference's format byte for
byte, so that a checkpoint written by either package restores in the
other.

Layout: one ``step_{step:010d}`` directory per step; each leaf of the
tree is a ``leaf_{i:05d}.npy`` file, in JAX's flattening order, plus a
``manifest.json`` with ``step``, ``time`` and per leaf its ``file``,
``shape``, ``dtype`` and the CRC32 of its raw bytes, keyed by the
reference's ``jax.tree_util.keystr`` path (``[0]['layers']['attn']['wq']``
for the parameters of a ``(params, opt_state)`` tuple, ``[1].m['embed']``
for a NamedTuple's field).  Writes are atomic (tmp dir + rename), so a
crash mid-save never corrupts the latest complete checkpoint: restart
picks the newest step that verifies.

A bfloat16 leaf is written as the reference's ``np.save`` of an
``ml_dtypes`` bfloat16 array writes it (header ``descr '<V2'``, manifest
dtype ``"bfloat16"``) and read back as raw 16-bit words viewed as
``torch.bfloat16``: no ``ml_dtypes`` is needed.  Leaves are torch tensors
(restored onto the device of the ``like`` tree's leaf), numpy arrays, or
Python ints (an int32 scalar on disk, the optimizer's step count).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

MANIFEST = "manifest.json"
BF16 = "bfloat16"


def leaf_paths(tree, path: str = "") -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's flattening order: dict keys
    sorted (``[k!r]``), NamedTuple fields in order (``.name``), tuple and
    list items (``[i]``)."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaf_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for k in tree._fields
                for pair in leaf_paths(getattr(tree, k), f"{path}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [pair for i, v in enumerate(tree)
                for pair in leaf_paths(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(like, leaves_iter):
    """``like``'s structure with its leaves taken in order from
    ``leaves_iter``."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves_iter) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, k), leaves_iter)
                            for k in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves_iter) for v in like)
    return next(leaves_iter)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (a host copy of its raw values, dtype name): a bfloat16
    tensor as its 16-bit words.  Always a copy, so that a later in-place
    update of the leaf (a CPU tensor's storage is shared with ``numpy()``)
    never reaches an async write."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        t = t.view(torch.int16) if bf16 else t
        # a device tensor's cpu() is a copy already
        a = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
        if bf16:
            return a.view(np.uint16), BF16
    elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        a = np.asarray(leaf, np.int32)
    else:
        a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(arr.tobytes())


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:                # np.save of ml_dtypes' bf16
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _to_leaf(arr: np.ndarray, dtype: str, like):
    """A stored array as a leaf like ``like``: a tensor on ``like``'s
    device (bf16 from its 16-bit words), an int, or a numpy array."""
    if dtype == BF16:
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    elif isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(arr)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
    else:
        return np.array(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = True

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- save -----------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Snapshot to host memory synchronously, write to disk (async)."""
        host = [(path, *_to_host(leaf)) for path, leaf in leaf_paths(tree)]
        self.wait()
        if self.async_save and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list) -> None:
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = tempfile.mkdtemp(dir=self.directory,
                               prefix=f".tmp_step_{step}_")
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for i, (path, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            _save(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"][path] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": _crc(arr),
            }
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore --------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        while steps:
            s = steps[-1]
            if self.verify(s):
                return s
            steps.pop()                 # corrupted/partial: fall back
        return None

    def verify(self, step: int) -> bool:
        d = os.path.join(self.directory, f"step_{step:010d}")
        mpath = os.path.join(d, MANIFEST)
        if not os.path.exists(mpath):
            return False
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            for meta in manifest["leaves"].values():
                arr = np.load(os.path.join(d, meta["file"]))
                if _crc(arr) != meta["crc32"]:
                    return False
            return True
        except Exception:
            return False

    def restore(self, step: int, like, shardings=None):
        """Restore into the structure of ``like`` (its leaves' devices;
        the stored dtypes).

        Elastic rescale: with ``shardings`` (a tree like ``like`` of
        ``sharding.specs.NamedSharding``s, or ``None`` leaves), each stored
        global array is placed on the mesh its sharding names, as a
        DTensor holding this rank's block — restoring a checkpoint written
        on one device onto a 2 x 2 mesh (or back) is the same code path."""
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, MANIFEST)) as f:
            manifest = json.load(f)
        out = []
        for key, leaf in leaf_paths(like):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(d, meta["file"]))
            shape = list(leaf.shape) if hasattr(leaf, "shape") else []
            if shape != meta["shape"]:
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{shape} vs {meta['shape']}")
            out.append(_to_leaf(arr, meta["dtype"], leaf))
        if shardings is not None:
            from repro_torch.sharding.specs import NamedSharding, distribute
            sh = [v for _, v in leaf_paths(shardings)]
            out = [distribute(t, s.spec, s.mesh)
                   if isinstance(s, NamedSharding) else t
                   for t, s in zip(out, sh)]
        return _rebuild(like, iter(out))
