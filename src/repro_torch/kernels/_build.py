"""Build the port's CUDA kernels with nvcc into ``_build/`` at first use.

Each source under ``csrc/`` becomes a shared library with a plain C
interface (loaded with ``ctypes``), named by a hash of its source and the
compiler flags, so a changed source rebuilds and an unchanged one is
reused.  ``build()`` starts one nvcc per stale source, all at once, and
waits for every one of them.  Only the sources in this directory are used.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"rmsnorm": "rmsnorm.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_tc": "flash_attention_tc.cu",
           "ssd_scan": "ssd_scan.cu",
           "ssd_scan_tc": "ssd_scan_tc.cu",
           # the CUDA-core kernels' first versions, timed beside them
           "flash_attention_v1": "v1/flash_attention.cu",
           "ssd_scan_v1": "v1/ssd_scan.cu"}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``, then
    ``$PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / SOURCES[name]).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile every named source whose library is missing, in parallel.

    Returns ``{name: compiler output}`` (empty for a library that was
    already built).  Raises with nvcc's output if a compile fails.
    """
    names = list(SOURCES) if names is None else list(names)
    logs = {n: "" for n in names}
    jobs = []
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        jobs.append((n, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, out, proc in jobs:
        logs[n], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {n} (exit {proc.returncode}):\n"
                          f"{logs[n]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of one kernel (building it first if needed)."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
