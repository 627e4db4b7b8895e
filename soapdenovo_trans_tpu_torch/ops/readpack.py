"""2-bit packed host -> device read transfer.

Port of ``soapdenovo_trans_tpu/ops/readpack.py``.  Reads are packed 4
bases a byte on the host (the native packer of io/native.py, or
vectorized numpy) and unpacked on the device by the consuming build
unit.  'N' bases (code 4) do not fit 2 bits, so their flat positions
(row*l + col) ride in a sparse int32 sideband whose capacity is a fixed
function of the batch shape; a batch with more N than that (above about
0.2% of the bases) is not packed and goes up as raw uint8.

The packing exists in the JAX package for a slow host-to-device link.
On a PCIe-attached card it loses: for one counting build unit (413,696
reads of 100 bp, 41.4 MB raw, 10.7 MB packed) ``chip_smoke.py`` phase 3
measured, on an NVIDIA H100 80GB HBM3 at 700 W, 3.8 ms for the raw
upload against 30.0 ms packed (the host pack 28.6 ms, the upload 1.1
ms, the unpack 0.3 ms; PERF.md has every run).  So ``stages/pregraph.count_reads`` uploads raw uint8 codes, and
this module serves a caller behind a slow link
(``dictionary.sorted_run_from_host_reads``).

The reference reads bases one char at a time into per-thread buffers
(src/readseq1by1.c:865-1222) and has no transfer to compress.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..io import native


class PackedReads(NamedTuple):
    data: np.ndarray    # (r, ceil(l/4)) uint8 — 4 bases a byte, LSB first
    n_flat: np.ndarray  # (ncap,) int32 flat (row*l+col) of N bases; r*l = none
    l: int              # unpacked read width


def n_cap_for(r: int, l: int) -> int:
    """Sideband capacity as a pure function of the batch shape."""
    return 1024 + (r * l) // 512


def pack_reads(codes: np.ndarray) -> Optional[PackedReads]:
    """Host-side 4x compression; None if the batch has too many Ns for
    the shape-determined sideband (the caller sends raw uint8).  The
    native packer where it is built, else the numpy formulation; both
    give the same arrays."""
    r, l = codes.shape
    ncap = n_cap_for(r, l)
    if native.available():
        nat = native.pack2bit(codes, ncap)
        return None if nat is None else PackedReads(nat[0], nat[1], l)
    n_mask = codes >= 4
    n_total = int(np.count_nonzero(n_mask))
    if n_total > ncap:
        return None
    lp = -(-l // 4)
    c = np.zeros((r, 4 * lp), np.uint8)
    np.bitwise_and(codes, 3, out=c[:, :l])
    v = c.reshape(r, lp, 4)
    data = v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4) \
        | (v[:, :, 3] << 6)
    n_flat = np.full(ncap, r * l, np.int32)
    if n_total:
        nr, nc = np.nonzero(n_mask)
        n_flat[:n_total] = (nr * l + nc).astype(np.int32)
    return PackedReads(np.ascontiguousarray(data), n_flat, l)


def unpack_reads(data: torch.Tensor, n_flat: torch.Tensor,
                 l: int) -> torch.Tensor:
    """Device-side unpack: (r, ceil(l/4)) uint8 -> (r, l) uint8 codes
    with the N positions restored to 4.  Sideband entries equal to r*l
    mean "none" and are masked out (the JAX package drops them as
    out-of-range scatter targets)."""
    r, lp = data.shape
    codes = torch.stack([(data >> s) & 3 for s in (0, 2, 4, 6)],
                        -1).reshape(r, 4 * lp)[:, :l].contiguous()
    flat = codes.view(-1)
    pos = n_flat.to(torch.int64)
    flat[pos[pos < r * l]] = 4
    return codes
