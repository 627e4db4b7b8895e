"""Vectorized read -> canonical k-mer chopping.

Port of ``soapdenovo_trans_tpu/ops/kmer.py`` (reference chopKmer4read,
src/prlHashReads.c:164-310): every read window becomes a canonical
k-mer with its preceding and following base in canonical orientation
(code 4 when absent).  Windows containing an 'N' are masked out, as in
the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import bits


class KmerStream(NamedTuple):
    """A flat batch of canonical k-mer observations."""

    kmers: torch.Tensor   # (N, W) int64 lanes, canonical
    prev: torch.Tensor    # (N,) uint8 base before the kmer (canon orient; 4=none)
    next: torch.Tensor    # (N,) uint8 base after the kmer (canon orient; 4=none)
    valid: torch.Tensor   # (N,) bool
    read_id: torch.Tensor  # (N,) int64 originating read row
    pos: torch.Tensor     # (N,) int64 window start within the read
    is_rc: torch.Tensor   # (N,) bool — canonical is the reverse complement


def chop_reads(seqs: torch.Tensor, lengths: torch.Tensor,
               k: int) -> KmerStream:
    """Chop a padded read batch into canonical k-mers.

    seqs: (R, L) uint8 base codes (0..3, 4 for N/pad), lengths: (R,).
    Returns N = R * (L - K + 1) rows, read-major then position; masked
    rows have valid=False.  Each lane is an OR of <= 16 strided base
    slices, so every op is batch-wide.
    """
    r, l = seqs.shape
    if l < k:
        raise ValueError(f"padded read length {l} < K={k}")
    p = l - k + 1
    w = bits.words_for_k(k)
    dev = seqs.device
    lengths = lengths.to(torch.int64)

    b = (seqs & 3).to(torch.int64)  # N clamped; N windows masked below
    n_prefix = torch.cat(
        [torch.zeros((r, 1), dtype=torch.int64, device=dev),
         torch.cumsum((seqs >= 4).to(torch.int32), 1)], 1)

    words = []
    for wi in range(w):           # wi = 0 is the most-significant lane
        q = w - 1 - wi            # lane index counted from the LSB
        acc = torch.zeros((r, p), dtype=torch.int64, device=dev)
        for i in range(k):        # base i of the window
            pbit = 2 * (k - 1 - i)
            if pbit // 32 == q:
                acc |= b[:, i:i + p] << (pbit % 32)
        words.append(acc)
    fwd = torch.stack(words, -1).reshape(r * p, w)

    can, use_rc = bits.canonical_pair(fwd, bits.reverse_complement(fwd, k))

    win = torch.arange(p, device=dev)[None, :]
    valid = ((win + k) <= lengths[:, None]) & \
        ((n_prefix[:, k:] - n_prefix[:, :p]) == 0)

    four = torch.full((r, 1), 4, dtype=torch.uint8, device=dev)
    prev_f = torch.cat([four, seqs[:, :p - 1]], 1)
    next_f = torch.cat([seqs[:, k:], four], 1)
    next_f = torch.where((win + k) < lengths[:, None], next_f, 4)

    prev_f = prev_f.reshape(-1)
    next_f = next_f.reshape(-1)
    prev_c = torch.where(use_rc, torch.where(next_f < 4, next_f ^ 2, 4),
                         prev_f)
    next_c = torch.where(use_rc, torch.where(prev_f < 4, prev_f ^ 2, 4),
                         next_f)

    read_id = torch.arange(r, device=dev).repeat_interleave(p)
    pos = torch.arange(p, device=dev).repeat(r)
    return KmerStream(can, prev_c.to(torch.uint8), next_c.to(torch.uint8),
                      valid.reshape(-1), read_id, pos, use_rc)
