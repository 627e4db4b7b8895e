"""Merge-path merge of two sorted packed-row arrays: the Hopper kernel.

Replaces the Pallas TPU kernel ``soapdenovo_trans_tpu/kernels/
merge_path.py`` (``_merge_device``; ``pl.pallas_call`` at :284) on the
counting path, ``dictionary.merge_runs``.  The CUDA source is
``csrc/merge_path.cu`` in this package; it is compiled for ``sm_90a``
with ``nvcc`` at first use into ``_build/`` and loaded with ``ctypes``
(``kernels/_nvcc.py``).

``merge_sorted_rows`` launches the kernel for CUDA tensors and runs the
plain PyTorch version (``merge_sorted_rows_plain``) only for CPU
tensors.  Both return exactly ``Na + Nb`` rows: the ``n + m`` live rows
ascending, ties A first, then all-ones sentinels with count 0 — so the
two agree row for row and count for count.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..ops import bits
from ..utils import profiling
from . import _nvcc

SOURCE = os.path.join(_nvcc.CSRC, "merge_path.cu")

LAUNCHES = 0  # kernel launches since the last reset (plain runs not counted)
_LIB = None


def build() -> str:
    """Compile csrc/merge_path.cu for sm_90a (once per source content)
    and return the shared library's path."""
    return _nvcc.build(SOURCE)


def _load():
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        lib.merge_path_launch.restype = ctypes.c_int
        lib.merge_path_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p] * 6)
        lib.merge_path_blocks.restype = ctypes.c_longlong
        lib.merge_path_blocks.argtypes = [ctypes.c_longlong]
        _LIB = lib
    return _LIB


def _live_scalar(x, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.int64, device=device)
    if t.dim() != 0:
        raise ValueError("live count must be a scalar")
    return t.contiguous()


def _check(rows: torch.Tensor, count: torch.Tensor, device) -> None:
    if rows.device != device or count.device != device:
        raise ValueError("merge inputs must lie on one device")
    if rows.dtype != torch.int64 or count.dtype != torch.int32:
        raise TypeError("rows must be int64 lanes and counts int32")
    if rows.dim() != 2 or rows.shape[1] != 2 or \
            count.shape != (rows.shape[0],):
        raise ValueError(f"rows must be (N, 2) with (N,) counts, got "
                         f"{tuple(rows.shape)} and {tuple(count.shape)}")
    if not (rows.is_contiguous() and count.is_contiguous()):
        raise ValueError("merge inputs must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned")


def merge_sorted_rows(a_rows, a_count, b_rows, b_count, n, m):
    """Merge two ascending (N, 2) row arrays with int32 counts, of which
    rows [0, n) and [0, m) are live (``n``, ``m``: ints or device
    scalars).  Returns (rows (Na+Nb, 2) int64, count (Na+Nb,) int32).
    Adds Na + Nb to the run's counter ``merge_path.rows``."""
    global LAUNCHES
    profiling.counter("merge_path.rows", a_rows.shape[0] + b_rows.shape[0])
    dev = a_rows.device
    if dev.type == "cpu":
        return merge_sorted_rows_plain(a_rows, a_count, b_rows, b_count,
                                       n, m)
    if dev.type != "cuda":
        raise ValueError(f"no merge kernel for device {dev}")
    _check(a_rows, a_count, dev)
    _check(b_rows, b_count, dev)
    na, nb = a_rows.shape[0], b_rows.shape[0]
    lib = _load()
    with torch.cuda.device(dev):
        n_t, m_t = _live_scalar(n, dev), _live_scalar(m, dev)
        out = torch.empty((na + nb, 2), dtype=torch.int64, device=dev)
        out_cnt = torch.empty(na + nb, dtype=torch.int32, device=dev)
        split = torch.empty(lib.merge_path_blocks(na + nb) + 1,
                            dtype=torch.int64, device=dev)
        err = lib.merge_path_launch(
            a_rows.data_ptr(), a_count.data_ptr(), b_rows.data_ptr(),
            b_count.data_ptr(), na, nb, n_t.data_ptr(), m_t.data_ptr(),
            split.data_ptr(), out.data_ptr(), out_cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"merge_path kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out, out_cnt


def merge_sorted_rows_plain(a_rows, a_count, b_rows, b_count, n, m):
    """Plain PyTorch merge: mask dead rows, concatenate, stable sort on
    the folded 64-bit key, gather the counts."""
    dev = a_rows.device
    a_live = torch.arange(a_rows.shape[0], device=dev) < n
    b_live = torch.arange(b_rows.shape[0], device=dev) < m
    top = torch.iinfo(torch.int64).max  # fold2 of the sentinel row
    keys = torch.cat([torch.where(a_live, bits.fold2(a_rows), top),
                      torch.where(b_live, bits.fold2(b_rows), top)])
    count = torch.cat([torch.where(a_live, a_count, 0),
                       torch.where(b_live, b_count, 0)])
    srt = torch.sort(keys, stable=True)
    return bits.unfold2(srt.values), count[srt.indices].to(torch.int32)
