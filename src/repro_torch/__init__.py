"""PyTorch port of the multichip wireless-interconnect simulator.

Same subpackage layout as ``repro`` (the JAX reference package), so each
module here has exactly one reference module.  This package imports
``torch`` and numpy only — never ``jax`` and never ``repro``; the
pure-numpy host modules (topology, routing, traffic tables) are kept as
copies.

Entry points take ``device=None``, which means the CUDA device; they
raise when no CUDA device is present unless ``device="cpu"`` is passed
explicitly (see ``repro_torch.device.resolve``).
"""
