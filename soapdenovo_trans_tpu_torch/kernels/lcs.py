"""The Hopper kernel of the Tour-Bus wave's identity check, and the
plain LCS it stands for.

``identity_check`` replaces the identity-check block of the JAX
package's jitted Tour-Bus wave (``soapdenovo_trans_tpu/graph/
tourbus.py``): ``_path_seq`` for each path (:116-133), the length gate
(:221-225), the LCS (:77-96, a 384-step ``lax.scan``; here
``lcs_scores_plain``) and the verdict (:230); the wave calls it once.
Its CUDA source is ``csrc/lcs.cu`` in this package (``identity_launch``:
one thread a row, the bases read from the edge pool, a bit-parallel
LCS); it is compiled for ``sm_90a`` with ``nvcc`` at first use into
``_build/`` and loaded with ``ctypes`` (``kernels/_nvcc.py``).

The wrapper launches the kernel for CUDA tensors and runs its plain
PyTorch version (``identity_check_plain``) only for CPU tensors.  It
may be captured into a CUDA graph (the Tour-Bus wave is,
``graph/tourbus.WaveProgram``): its launch sets no attribute and reads
nothing back, and its counter counts executions.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..ops.index import gather2
from . import _nvcc

SOURCE = os.path.join(_nvcc.CSRC, "lcs.cu")
MAX_CAP = 512  # the kernel keeps at most 512 bits of V a row (seq_cap)
MAX_SLOTS = 64  # node slots a path in identity_check (its shared memory)

# identity_launch executions since the last reset: each launch outside a
# CUDA graph capture, and each replay of a graph that holds one (the
# graph's owner adds them, ``graph/tourbus.WaveProgram``)
IDENTITY_LAUNCHES = 0
IDENTITY_CAPTURED = 0  # identity_launch launches recorded into CUDA graphs
_LIB = None
_RESERVED = set()  # devices where identity_reserve() ran


def build() -> str:
    """Compile csrc/lcs.cu for sm_90a (once per source content) and
    return the shared library's path."""
    return _nvcc.build(SOURCE)


def _load():
    global _LIB
    if _LIB is None:
        lib = _nvcc.load(SOURCE)
        lib.identity_launch.restype = ctypes.c_int
        lib.identity_launch.argtypes = ([ctypes.c_void_p] * 11
                                        + [ctypes.c_longlong] * 6
                                        + [ctypes.c_void_p])
        lib.identity_reserve.restype = ctypes.c_int
        lib.identity_reserve.argtypes = []
        lib.identity_max_cap.restype = ctypes.c_longlong
        lib.identity_max_cap.argtypes = []
        if lib.identity_max_cap() != MAX_CAP:
            raise RuntimeError("csrc/lcs.cu and kernels/lcs.py disagree "
                               "on the longest path sequence")
        _LIB = lib
    return _LIB


def _reserve(lib, dev) -> None:
    """Raise identity_kernel's shared-memory limit on ``dev`` once, before
    its first launch there; never inside a CUDA graph capture (the first
    wave of a pinch runs eagerly, so a captured wave finds it done)."""
    if dev.index in _RESERVED:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"identity kernel captured on {dev} before any "
                           f"launch there outside a capture")
    err = lib.identity_reserve()
    if err:
        raise RuntimeError(f"identity kernel: cudaFuncSetAttribute failed: "
                           f"CUDA error {err}")
    _RESERVED.add(dev.index)


def lcs_scores_plain(a, b, la, lb, cap: int):
    """(P,) int64: the LCS length of a[r, :la[r]] and b[r, :lb[r]] for
    each row r — the identity measure for compareSequences' F-matrix
    check (bubble.c:425-497): matches / max(len) >= 0.9 accepts.  a, b:
    (P, cap) uint8; la, lb: (P,) int64, a length <= 0 an empty string,
    one above cap the whole row.  Pads a with 254 and b with 255, as the
    JAX package does, so it is the true LCS where a[r, :la] holds no 255
    and b[r, :lb] no 254; the wave's bases are 0-3."""
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


def _path_seq(nodes, length, seq_off, seq_pool, seq_cap: int):
    """Concatenate the appended-base sequences of a node list into a
    fixed (C, seq_cap) buffer; returns (seq, total_len)."""
    lens = gather2(length, nodes, 0)                       # (C, m)
    cum = torch.cumsum(lens, 1) - lens                      # exclusive starts
    total = lens.sum(1)
    p = torch.arange(seq_cap, device=nodes.device)[None, :, None]
    inside = (p >= cum[:, None, :]) & (p < (cum + lens)[:, None, :])
    seg = inside.to(torch.uint8).argmax(2)                  # (C, S)
    hit = inside.any(2)
    node_p = torch.gather(nodes, 1, seg)
    off = gather2(seq_off, node_p, 0)
    start = torch.gather(cum, 1, seg)
    pool_idx = off + (torch.arange(seq_cap, device=nodes.device)[None, :]
                      - start)
    base = seq_pool[pool_idx.clamp(0, seq_pool.shape[0] - 1)]
    return torch.where(hit, base, 250), total


def _check_identity(maj, mnr, found, length, seq_off, seq_pool,
                    seq_cap: int) -> None:
    xs = (maj, mnr, found, length, seq_off, seq_pool)
    if len({x.device for x in xs}) != 1:
        raise ValueError("identity inputs must lie on one device")
    if not all(x.dtype == torch.int64 for x in (maj, mnr, length, seq_off)):
        raise TypeError("maj, mnr, length and seq_off must be int64")
    if found.dtype != torch.bool:
        raise TypeError("found must be bool")
    if seq_pool.dtype != torch.uint8:
        raise TypeError("seq_pool must be uint8")
    if not 0 <= seq_cap <= MAX_CAP:
        raise ValueError(f"seq_cap {seq_cap} outside the kernel's "
                         f"0..{MAX_CAP}")
    if maj.dim() == 2 and maj.shape[1] > MAX_SLOTS:
        raise ValueError(f"{maj.shape[1]} node slots a path, the kernel "
                         f"takes at most {MAX_SLOTS}")
    c = maj.shape[0] if maj.dim() == 2 else -1
    e = length.shape[0] if length.dim() == 1 else -1
    if mnr.shape != maj.shape or found.shape != (c,) or e < 1 or \
            seq_off.shape != (e,) or seq_pool.dim() != 1 or \
            seq_pool.shape[0] < 1:
        raise ValueError(f"maj and mnr must be (C, m), found (C,), length "
                         f"and seq_off (E,) and seq_pool (S,), E, S >= 1; "
                         f"got {[tuple(x.shape) for x in xs]}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("identity inputs must be contiguous")


def identity_check(maj, mnr, found, length, seq_off, seq_pool, diff: int,
                   seq_cap: int):
    """The Tour-Bus wave's identity check of C candidate rows: returns
    (len_a, len_b, compared, ok, lcs), each (C,), int64, int64, bool,
    bool, int64.

    maj, mnr: (C, m) int64 node lists in path order, -1 padded; found:
    (C,) bool; length, seq_off: (E,) int64 and seq_pool: (S,) uint8, an
    ``EdgeGraph``'s.  len_a sums length[n] over the nodes n >= 0 of maj
    (len_b over mnr); compared = found & |len_a - len_b| <= diff &
    len_a <= seq_cap & len_b <= seq_cap; lcs is the LCS of the two path
    sequences (each node's seq_pool[seq_off[n]:seq_off[n] + length[n]],
    in column order, the pool index clamped into the pool) where
    compared, else 0; ok = compared & lcs·10 >= 9·max(len_a, len_b).
    seq_cap <= MAX_CAP.

    The kernel computes the true LCS; the plain version pads as the JAX
    package does, so the two agree where the pool holds no byte 254 or
    255 (an EdgeGraph's holds bases 0-3)."""
    global IDENTITY_LAUNCHES, IDENTITY_CAPTURED
    _check_identity(maj, mnr, found, length, seq_off, seq_pool, seq_cap)
    dev = maj.device
    if dev.type == "cpu":
        return identity_check_plain(maj, mnr, found, length, seq_off,
                                    seq_pool, diff, seq_cap)
    if dev.type != "cuda":
        raise ValueError(f"no identity kernel for device {dev}")
    lib = _load()
    c, m = maj.shape
    with torch.cuda.device(dev):
        _reserve(lib, dev)
        longs = torch.empty((3, c), dtype=torch.int64, device=dev)
        flags = torch.empty((2, c), dtype=torch.bool, device=dev)
        if c:
            err = lib.identity_launch(
                maj.data_ptr(), mnr.data_ptr(), found.data_ptr(),
                length.data_ptr(), seq_off.data_ptr(), seq_pool.data_ptr(),
                longs[0].data_ptr(), longs[1].data_ptr(),
                flags[0].data_ptr(), flags[1].data_ptr(),
                longs[2].data_ptr(), c, m, length.shape[0],
                seq_pool.shape[0], diff, seq_cap,
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"identity kernel launch failed: CUDA "
                                   f"error {err}")
            if torch.cuda.is_current_stream_capturing():
                IDENTITY_CAPTURED += 1
            else:
                IDENTITY_LAUNCHES += 1
    return longs[0], longs[1], flags[0], flags[1], longs[2]


def identity_check_plain(maj, mnr, found, length, seq_off, seq_pool,
                         diff: int, seq_cap: int):
    """``identity_check`` in plain PyTorch: both paths' sequences into
    (C, seq_cap) buffers, the gate, the LCS loop and the verdict, as the
    JAX wave computes them."""
    seq_a, len_a = _path_seq(maj, length, seq_off, seq_pool, seq_cap)
    seq_b, len_b = _path_seq(mnr, length, seq_off, seq_pool, seq_cap)
    compared = found & ((len_a - len_b).abs() <= diff) & \
        (len_a <= seq_cap) & (len_b <= seq_cap)
    lcs = lcs_scores_plain(seq_a, seq_b, torch.where(compared, len_a, 0),
                           torch.where(compared, len_b, 0), seq_cap)
    ok = compared & (lcs * 10 >= 9 * torch.maximum(len_a, len_b))
    return len_a, len_b, compared, ok, lcs
