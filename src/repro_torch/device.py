"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means CUDA; a run never falls back to the CPU silently.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
