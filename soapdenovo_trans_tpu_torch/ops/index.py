"""Gathers and scatters over flat index arrays, shared by the graph
passes, the kernels' plain versions and the stages.

A gather reads ``fill`` for an index outside ``0..len(x) - 1`` (-1 is
the usual "none"); a scatter or a segment sum of size ``n`` takes index
``n`` as its drop slot, so a masked-out entry is sent there rather than
filtered.  None of them copies a host value to the device, so a CUDA
graph can capture each one.
"""

from __future__ import annotations

import torch


def gather_or(x, idx, fill):
    """x[idx], or ``fill`` where idx lies outside 0..len(x) - 1."""
    ok = (idx >= 0) & (idx < x.shape[0])
    return torch.where(ok, x[idx.clamp(0, x.shape[0] - 1)], fill)


def gather2(x, nodes, fill):
    """``gather_or`` over a (C, m) table of indices, such as a wave's
    node lists; returns (C, m)."""
    return gather_or(x, nodes.reshape(-1), fill).reshape(nodes.shape)


def scatter(size: int, idx, vals, fill) -> torch.Tensor:
    """(size,) of ``fill`` with vals written at idx; idx == size drops.
    Callers write unique indices below ``size``."""
    out = torch.full((size + 1,), fill, dtype=vals.dtype,
                     device=vals.device)
    out[idx] = vals
    return out[:size]


def scatter_true(n: int, idx) -> torch.Tensor:
    """(n,) bool, True at idx; idx == n drops."""
    return torch.zeros(n + 1, dtype=torch.bool,
                       device=idx.device).index_fill_(0, idx, True)[:n]


def segment_sum(vals, seg, n: int):
    """Sum of vals per segment id in [0, n]; id n is the drop slot."""
    return vals.new_zeros(n + 1).index_add_(0, seg, vals)[:n]
