"""Hand-written CUDA kernels for Hopper (sm_90a), their wrappers and plain
PyTorch versions.  ``<name>.py`` wraps ``csrc/<name>.cu``; ``ref.py`` holds
the plain versions; ``ops.py`` the public functions; ``_build.py`` the
nvcc build, done at first use into ``_build/`` (listed in .gitignore)."""

import torch


def forbid_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if a kernel's caller asks for a gradient through it.

    A kernel's output is filled outside autograd, so a backward through it
    would silently drop its inputs' gradients.  The reference's Pallas
    kernels have no gradient either (``jax.grad`` through them fails), and
    the reference trains with ``impl="blockwise"``.  Checked on the CPU
    route too, so that both routes refuse the same calls."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no "
            "backward (nor has the reference's Pallas kernel); train with "
            "impl='blockwise', or call it under torch.no_grad()")
