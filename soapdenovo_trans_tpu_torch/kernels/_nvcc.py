"""Build a CUDA source of ``csrc/`` for sm_90a and load it with ctypes.

Each source compiles alone with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), in
``_build/``, keyed by the source's hash: a changed source builds anew,
an unchanged one is built once per checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the "
                           "CUDA toolkit")
    return path


def build(source: str) -> str:
    """Compile ``source`` (a path) for sm_90a, once per source content,
    and return the shared library's path."""
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    os.replace(tmp, so)
    return so


def load(source: str) -> ctypes.CDLL:
    """The built library of ``source``, loaded."""
    return ctypes.CDLL(build(source))
