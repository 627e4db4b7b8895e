"""ctypes binding for the native FASTA/FASTQ/BAM batch decoder
(``csrc/fastx_decoder.cpp`` at the repository root) — the C++
replacement for the reference's readseq1by1.c + aio read-ahead.

A copy of ``available``, ``read_batches`` and ``pack2bit`` (the 2-bit
upload packer of ops/readpack.py) from
``soapdenovo_trans_tpu/io/native.py``: the port loads no module of the
JAX package, so a run of the port stands on its own where only torch is
installed.  ``read_rows``, the unpadded blocks from which ``io/fastx``
interleaves a paired library's mates, is the port's own.  The library
is compiled with g++ (zlib linked) at first use into this package's
``_build/``; without a toolchain ``available()`` is False and the
callers take the pure-Python readers, which yield the same batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "csrc", "fastx_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lib = None
_checked = False
_LOCK = threading.Lock()


def _build() -> str:
    """Compile the decoder once per source content; returns the path of
    the shared library."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libfastx_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp,
                        "-lz"], check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built at the first call; None without a
    toolchain.  A caller that arrives during the first build (the
    read-ahead thread of io/fastx) waits for it under the lock instead
    of taking None and the Python decoder."""
    global _lib, _checked
    with _LOCK:
        if not _checked:
            _checked = True
            _lib = _bind()
        return _lib


def _bind() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError):
        return None
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_next_batch.restype = ctypes.c_long
    lib.fastx_next_batch.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_long]
    lib.fastx_close.restype = None
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.pack2bit.restype = ctypes.c_long
    lib.pack2bit.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_long]
    return lib


def pack2bit(codes: np.ndarray, ncap: int
             ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Native 4-bases/byte pack + N-position sideband; None when the
    library is unavailable or the batch has more Ns than ncap (the
    caller uploads raw uint8).  See readpack.pack_reads for the
    contract."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    r, l = codes.shape
    out = np.empty((r, (l + 3) // 4), np.uint8)
    n_flat = np.empty(ncap, np.int32)
    n = lib.pack2bit(codes, r, l, out, n_flat, ncap)
    if n < 0:
        return None
    n_flat[n:] = r * l
    return out, n_flat, int(n)


def available() -> bool:
    return _load() is not None


def _decode(path: str, rows: int, max_len: int
            ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (codes (rows, L) uint8, lengths (rows,) int32, n) until
    EOF, n > 0 the rows decoded; rows past n are length-0 padding."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    h = lib.fastx_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            codes = np.full((rows, max_len), 4, np.uint8)
            lengths = np.zeros(rows, np.int32)
            n = lib.fastx_next_batch(h, codes, lengths, rows, max_len)
            if n < 0:
                raise ValueError(f"{path}: malformed FASTA/FASTQ")
            if n == 0:
                return
            yield codes, lengths, n
            if n < rows:
                return
    finally:
        lib.fastx_close(h)


def read_batches(path: str, batch_size: int, max_len: int
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (codes (B, L) uint8, lengths (B,) int32) until EOF.
    The final batch is zero-length-padded to batch_size."""
    for codes, lengths, _ in _decode(path, batch_size, max_len):
        yield codes, lengths


def read_rows(path: str, rows: int, max_len: int
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield the reads of ``path`` as (codes (n, L) uint8, lengths (n,)
    int32) blocks of ``rows`` reads, the last one shorter and none
    padded, so a length-0 read stays apart from the end of the file."""
    for codes, lengths, n in _decode(path, rows, max_len):
        yield codes[:n], lengths[:n]
