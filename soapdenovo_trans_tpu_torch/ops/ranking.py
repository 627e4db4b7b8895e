"""Parallel list ranking with cycle breaking.

Port of ``soapdenovo_trans_tpu/ops/ranking.py``: given a backward
pointer per element, each element's chain head and rank by pointer
doubling in O(log n) gather rounds; closed cycles are broken at their
minimum element id first.  One form only — the JAX package's per-round
split above ``STEPWISE_N`` works around a TPU fault.
"""

from __future__ import annotations

import torch


def list_rank(prev: torch.Tensor, exists: torch.Tensor):
    """prev[i] = predecessor id or -1.  Returns (head, rank, is_head).

    head[i]: first element of i's chain; rank[i]: distance from head;
    is_head: exists & (effective prev == -1, after cycle breaking).
    Elements with exists=False must have prev == -1 and are ignored.
    """
    n = prev.shape[0]
    steps = max(1, n.bit_length())
    self_idx = torch.arange(n, device=prev.device)

    # pass 1: cycle detection (chains converge to a head whose prev is
    # -1; cycle members always see a live predecessor) + min id
    parent = torch.where(prev >= 0, prev, self_idx)
    mn = self_idx
    for _ in range(steps):
        mn = torch.minimum(mn, mn[parent])
        parent = parent[parent]
    on_cycle = exists & (prev[parent] >= 0)
    prev = torch.where(on_cycle & (mn == self_idx), -1, prev)

    # pass 2: ranking with heads fixed
    parent = torch.where(prev >= 0, prev, self_idx)
    rank = (prev >= 0).to(torch.int64)
    for _ in range(steps):
        rank = rank + rank[parent]
        parent = parent[parent]
    return parent, rank, exists & (prev < 0)
