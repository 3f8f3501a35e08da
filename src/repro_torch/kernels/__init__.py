"""Hand-written CUDA kernels for Hopper (sm_90a), their wrappers and plain
PyTorch versions.  ``<name>.py`` wraps ``csrc/<name>.cu``; ``ref.py`` holds
the plain versions; ``ops.py`` the public functions; ``_build.py`` the
nvcc build, done at first use into ``_build/`` (listed in .gitignore)."""
