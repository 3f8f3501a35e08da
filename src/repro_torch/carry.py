"""Carry simulator state across the JAX reference and the port.

The reference's ``SimStatic``/``SimState`` are NamedTuples of arrays; the
port's have the same leaf names, shapes and dtypes.  Given as
``{name: np.ndarray}`` (for example ``{k: np.asarray(v) for k, v in
jax_state._asdict().items()}``), they become the port's tuples on a
device, and back.  This is the simulator's counterpart of loading
weights: a test can start both engines from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.simulator import SimState, SimStatic


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
