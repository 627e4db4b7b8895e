"""Routed primitives for mesh-resident graph state.

Port of ``soapdenovo_trans_tpu/parallel/sharded_graph.py``.  The k-mer
table, and the de Bruijn graph derived from it, is prefix-sharded over
the mesh (parallel/sharded_count.py) and is never gathered to one
device.  Every graph pass needs three cross-shard primitives:

* routed gather  — ``x[idx]`` where ``x`` is sharded by contiguous
  global index ranges and ``idx`` is arbitrary: queries are bucketed by
  owner shard, moved with one exchange, answered locally, moved back;
* routed scatter — segment add/max/or into globally indexed rows:
  (idx, val) records are bucketed to the owner, one exchange, a local
  segment reduction;
* routed lookup  — the search_kmerset analog (src/newhash.c:239-283):
  multiword keys are bucketed by the inverse-CDF split points the
  resident table was built with, answered with the owner's local
  ``dictionary.lookup``, and returned as GLOBAL row ids
  (``shard * cap + local row``).

Global index convention: shard ``s`` owns rows ``[s*cap, (s+1)*cap)``
of every sharded array, ``cap`` being the common length of the shards
(a sharded array is a list of D tensors, parallel/mesh.py).  The
exchange is ragged, every bucket has its exact length, so nothing can
overflow: the JAX package's static bucket capacity, its ``dropped``
counter and its retry loop have no counterpart here.

Records are bucketed by one stable sort on the owner alone; the order
inside a bucket decides nothing, because the answers are put back by
the sort's own permutation.  A lane a shard owns itself is answered in
place and never enters a bucket: in pointer doubling most lanes point
at themselves.

``sharded_list_rank`` composes the gather into pointer-doubling chain
ranking (the sharded twin of ops/ranking.list_rank), which powers tip
clipping and unitig condensation on the mesh.
"""

from __future__ import annotations

from typing import List

import torch

from ..ops import dictionary
from . import sharded_count
from .mesh import Mesh, Sharded

# what an untouched slot of a max-scatter reads
_NEG = -(2 ** 31) + 1


def _unbucket(pieces, order, m: int, fill) -> torch.Tensor:
    """Answers, one piece a destination in bucket order, back to the
    (m, ...) query slots; slots that were sent nowhere read ``fill``."""
    got = torch.cat(pieces)
    out = torch.full((m,) + got.shape[1:], fill, dtype=got.dtype,
                     device=got.device)
    out[order[:got.shape[0]]] = got
    return out


class Router:
    """The routed primitives over arrays of ``cap_local`` rows a shard."""

    def __init__(self, mesh: Mesh, cap_local: int):
        self.mesh = mesh
        self.cap = cap_local
        self.d = mesh.d

    def _owners(self, idx: Sharded):
        """Per shard: owner with the self-owned lanes taken out, the
        local offset, and the self-owned mask."""
        def step(s, idx_s):
            valid = (idx_s >= 0) & (idx_s < self.d * self.cap)
            owner = torch.where(valid, idx_s // self.cap, self.d)
            off = torch.where(valid, idx_s % self.cap, 0)
            is_self = owner == s
            return owner.masked_fill(is_self, self.d), off, is_self

        return zip(*self.mesh.map(step, idx))

    def gather(self, x: Sharded, idx: Sharded) -> Sharded:
        """x: (cap, F) a shard; idx: (m,) global ids a shard, negative
        for none (m may differ between shards) -> (m, F), -1 where idx
        is negative."""
        owner, off, is_self = self._owners(idx)
        route = self.mesh.route(owner)
        req = self.mesh.send(route, off)
        back = self.mesh.all_to_all(self.mesh.map(
            lambda s, x_s: [x_s[r] for r in req[s]], x))

        def finish(s, x_s, off_s, self_s, order):
            routed = _unbucket(back[s], order, off_s.shape[0], -1)
            mine = x_s[torch.where(self_s, off_s, 0)]
            return torch.where(self_s[:, None], mine, routed)

        return self.mesh.map(finish, x, off, is_self, route.order)

    def gather1(self, x: Sharded, idx: Sharded) -> Sharded:
        """x: (cap,) a shard -> (m,): the single-field gather."""
        return [g[:, 0] for g in self.gather([v[:, None] for v in x], idx)]

    def scatter(self, idx: Sharded, vals: Sharded, op: str = "add"
                ) -> Sharded:
        """idx: (m,) global ids or negative; vals: (m, F) integers ->
        acc (cap, F) a shard.  op: add | max | or.  An untouched slot
        reads 0, or ``_NEG`` under max."""
        if op not in ("add", "max", "or"):
            raise ValueError(op)
        owner, off, is_self = self._owners(idx)
        route = self.mesh.route(owner)
        r_off = self.mesh.send(route, off)
        r_val = self.mesh.send(route, vals)
        cap = self.cap

        ident = _NEG if op == "max" else 0

        def reduce(s, off_s, val_s, self_s):
            # self-owned records fold in locally.  The others of this
            # shard's own records fold the identity into a slot picked
            # by their position: one spare slot for all of them would
            # serialize millions of atomic updates on one address
            spread = torch.arange(off_s.shape[0], device=off_s.device) % cap
            tgt = torch.cat(r_off[s] + [torch.where(self_s, off_s, spread)])
            val = torch.cat(r_val[s] + [
                torch.where(self_s[:, None], val_s, ident)])
            acc = torch.full((cap,) + val.shape[1:], ident, dtype=val.dtype,
                             device=val.device)
            if op == "add":
                return acc.index_add_(0, tgt, val)
            return acc.scatter_reduce_(
                0, tgt[:, None].expand_as(val), val, "amax")

        return self.mesh.map(reduce, off, vals, is_self)

    def scatter1(self, idx: Sharded, vals: Sharded, op: str = "add"
                 ) -> Sharded:
        return [a[:, 0] for a in self.scatter(
            idx, [v[:, None] for v in vals], op=op)]

    def lookup(self, keys: Sharded, n: List[int], deleted: Sharded,
               queries: Sharded, k: int) -> Sharded:
        """Route multiword key queries to their owners.  keys: (cap, W)
        ascending a shard, rows [0, n[s]) live; deleted: (cap,) bool;
        queries: (m, W), the all-ones sentinel for none -> (m,) GLOBAL
        row ids, -1 for missing, dead (>= n or deleted) and sentinel
        queries."""
        bounds = sharded_count.owner_bounds_tensor(k, self.d)

        def owners(s, q):
            sentinel = (q == dictionary.SENTINEL).all(-1)
            owner = sharded_count.owner_of(q[:, 0], bounds).masked_fill(
                sentinel, self.d)
            is_self = owner == s  # answered locally, skips the buckets
            return owner.masked_fill(is_self, self.d), is_self

        owner, is_self = zip(*self.mesh.map(owners, queries))
        route = self.mesh.route(owner)
        req = self.mesh.send(route, queries)

        def answer(s, keys_s, del_s, q):
            rows = dictionary.lookup(keys_s, q)
            safe = rows.clamp(min=0)
            alive = (rows >= 0) & (rows < n[s]) & ~del_s[safe]
            return torch.where(alive, rows + s * self.cap, -1)

        back = self.mesh.all_to_all(self.mesh.map(
            lambda s, keys_s, del_s: [answer(s, keys_s, del_s, q)
                                      for q in req[s]], keys, deleted))

        def finish(s, keys_s, del_s, q, self_s, order):
            routed = _unbucket(back[s], order, q.shape[0], -1)
            mine = answer(s, keys_s, del_s, torch.where(
                self_s[:, None], q, dictionary.SENTINEL))
            return torch.where(self_s, mine, routed)

        return self.mesh.map(finish, keys, deleted, queries, is_self,
                             route.order)


def sharded_list_rank(router: Router, prev: Sharded, exists: Sharded):
    """Pointer-doubling chain ranking over a sharded id space: the mesh
    twin of ops/ranking.list_rank (cycles broken at their minimum id).

    prev: (cap,) global predecessor ids or -1 a shard; exists: (cap,)
    bool.  Returns (head global, rank, is_head), a list each.  Every
    round is one routed gather of (parent, value) pairs.

    A round asks only for the lanes that may still move.  A lane whose
    parent is itself never moves (a head's value is its own, and 0 in
    the second pass); a lane whose parent does not move in a round
    points at such a fixed point from then on, so after that round's
    update neither its parent nor its value changes again (a minimum
    taken twice, or 0 added).  Such lanes leave the round: the work of
    a round is the lanes still moving, not the id space, and the
    doubling ends when none is left, after about log2 of the longest
    chain rounds instead of log2 of the id space, with the same result
    as every round over every lane.  (On a cycle whose length is no
    power of two the first pass's pointers never rest, and it runs
    every round.)
    """
    mesh, m = router.mesh, router.cap
    steps = max(1, (mesh.d * m).bit_length())
    self_idx = mesh.map(
        lambda s, p: s * m + torch.arange(m, device=p.device), prev)

    def doubled(parent, val, combine):
        # one row a lane, (parent, value), updated in place; the reads
        # of a round are queued before its writes on every card
        state = [torch.stack(pv, -1) for pv in zip(parent, val)]
        moving = mesh.map(lambda s, p, i: (p != i).nonzero()[:, 0],
                          parent, self_idx)

        def update(s, x, lanes, got):
            old = x[lanes]
            x[lanes] = torch.stack([got[:, 0], combine(old[:, 1],
                                                       got[:, 1])], -1)
            return lanes[got[:, 0] != old[:, 0]]

        for _ in range(steps):
            if not any(lanes.numel() for lanes in moving):
                break
            got = router.gather(state, mesh.map(
                lambda s, x, lanes: x[lanes, 0], state, moving))
            moving = mesh.map(update, state, moving, got)
        return [x[:, 0] for x in state], [x[:, 1] for x in state]

    # pass 1: cycle detection + min-id propagation (parent pointers are
    # always valid ids, so the gathers never miss)
    parent = [torch.where(p >= 0, p, i) for p, i in zip(prev, self_idx)]
    parent, mn = doubled(parent, self_idx, torch.minimum)
    prev_at_parent = router.gather1(prev, parent)
    prev = [torch.where(e & (pp >= 0) & (lo == i), -1, p)
            for p, e, pp, lo, i in zip(prev, exists, prev_at_parent, mn,
                                       self_idx)]

    # pass 2: ranking with heads fixed
    parent = [torch.where(p >= 0, p, i) for p, i in zip(prev, self_idx)]
    parent, rank = doubled(parent, [(p >= 0).to(torch.int64) for p in prev],
                           torch.add)
    return parent, rank, [e & (p < 0) for e, p in zip(exists, prev)]
