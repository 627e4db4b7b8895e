"""LCS lengths of a batch of byte-string pairs: the Hopper kernel of the
Tour-Bus identity check.

Replaces the JAX package's ``graph/tourbus.py:77-96`` ``_lcs_scores``,
a 384-step ``lax.scan`` inside the jitted Tour-Bus wave (an XLA device
loop, not a Pallas kernel).  The CUDA source is ``csrc/lcs.cu`` in this
package (a bit-parallel LCS, one warp a pair); it is compiled for
``sm_90a`` with ``nvcc`` at first use into ``_build/`` and loaded with
``ctypes`` (``kernels/_nvcc.py``).

``lcs_scores`` launches the kernel for CUDA tensors and runs the plain
PyTorch version (``lcs_scores_plain``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _nvcc

SOURCE = os.path.join(_nvcc.CSRC, "lcs.cu")
MAX_CAP = 512  # the kernel keeps at most 8 64-bit words of V a pair

LAUNCHES = 0  # kernel launches since the last reset (plain runs not counted)
_LIB = None


def build() -> str:
    """Compile csrc/lcs.cu for sm_90a (once per source content) and
    return the shared library's path."""
    return _nvcc.build(SOURCE)


def _load():
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        lib.lcs_launch.restype = ctypes.c_int
        lib.lcs_launch.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_longlong] * 2
                                   + [ctypes.c_void_p])
        lib.lcs_max_cap.restype = ctypes.c_longlong
        lib.lcs_max_cap.argtypes = []
        if lib.lcs_max_cap() != MAX_CAP:
            raise RuntimeError("csrc/lcs.cu and kernels/lcs.py disagree "
                               "on the longest row")
        _LIB = lib
    return _LIB


def _check(a, b, la, lb, cap: int) -> None:
    if not (a.device == b.device == la.device == lb.device):
        raise ValueError("LCS inputs must lie on one device")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError("a and b must be uint8")
    if la.dtype != torch.int64 or lb.dtype != torch.int64:
        raise TypeError("la and lb must be int64")
    if not 0 <= cap <= MAX_CAP:
        raise ValueError(f"cap {cap} outside the kernel's 0..{MAX_CAP}")
    p = a.shape[0] if a.dim() == 2 else -1
    if a.shape != (p, cap) or b.shape != (p, cap) or \
            la.shape != (p,) or lb.shape != (p,):
        raise ValueError(f"a and b must be (P, {cap}) with (P,) lengths, "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(la.shape)}, {tuple(lb.shape)}")
    if not all(x.is_contiguous() for x in (a, b, la, lb)):
        raise ValueError("LCS inputs must be contiguous")


def lcs_scores(a, b, la, lb, cap: int):
    """(P,) int64: the length of the longest common subsequence of
    a[r, :min(la[r], cap)] and b[r, :min(lb[r], cap)] for each row r
    (a length <= 0 is an empty string).  a, b: (P, cap) uint8; la, lb:
    (P,) int64; cap <= MAX_CAP.

    The kernel computes exactly that.  The plain version pads a with
    254 and b with 255, as the JAX package does, so it equals it where
    a[r, :la] holds no 255 and b[r, :lb] no 254; the wave's bases are
    0-3."""
    global LAUNCHES
    _check(a, b, la, lb, cap)
    dev = a.device
    if dev.type == "cpu":
        return lcs_scores_plain(a, b, la, lb, cap)
    if dev.type != "cuda":
        raise ValueError(f"no LCS kernel for device {dev}")
    lib = _load()
    p = a.shape[0]
    with torch.cuda.device(dev):
        out = torch.empty(p, dtype=torch.int64, device=dev)
        if p == 0:
            return out
        err = lib.lcs_launch(a.data_ptr(), b.data_ptr(), la.data_ptr(),
                             lb.data_ptr(), out.data_ptr(), p, cap,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lcs kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def lcs_scores_plain(a, b, la, lb, cap: int):
    """LCS length between a[:la] and b[:lb] per batch row — the
    identity measure for compareSequences' F-matrix check
    (bubble.c:425-497): matches / max(len) >= 0.9 accepts."""
    pos = torch.arange(cap, device=a.device)[None, :]
    ar = torch.where(pos < la[:, None], a, 254)
    br = torch.where(pos < lb[:, None], b, 255)
    row = torch.zeros((a.shape[0], cap + 1), dtype=torch.int64,
                      device=a.device)
    for i in range(cap):
        cand = row[:, :-1] + (ar[:, i:i + 1] == br)
        upper = torch.maximum(cand, row[:, 1:])
        row = torch.cat([row[:, :1], torch.cummax(upper, 1).values], 1)
    return row[:, -1]
