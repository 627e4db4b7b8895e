"""Mesh-resident map stage: sharded contig index + routed read voting.

Port of ``soapdenovo_trans_tpu/parallel/sharded_map.py``.  The
reference threads BOTH hot read passes — the pregraph hash build AND
prlRead2Ctg (src/prlRead2Ctg.c:656); prlHashCtg (src/prlHashCtg.c:287)
shards the contig k-mer index over the same hash route.  This module is
their mesh twin:

* shard_index — split the dense sorted ContigIndex (stages/map.py) into
  contiguous key ranges along the SAME inverse-CDF word-0 boundaries the
  pregraph table uses (sharded_count._owner_boundaries), so the routed
  lookup's owner function applies unchanged.
* map_reads_sharded — reads are data-parallel over the shards; each
  shard chops its block, one routed lookup resolves every k-mer to a
  global index row, one routed gather pulls (ctg, pos, orient), and
  parse1read's voting (stages/map.vote) runs per shard.  Only the
  per-read placements and the group rows return, to one device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..ops import dictionary, kmer
from ..stages import map as map_stage
from . import sharded_count, sharded_graph
from .mesh import Mesh, Sharded


class ShardedContigIndex(NamedTuple):
    """ContigIndex split into per-shard contiguous key ranges, every
    shard padded to ``cap`` rows (global row = shard * cap + row)."""

    keys: Sharded          # (cap, W) int64 lanes ascending per shard
    payload: Sharded       # (cap, 3) int64: ctg, pos, is_rc
    n: List[int]           # live rows per shard
    deleted: Sharded       # (cap,) bool, all False (lookup's contract)
    ctg_len: torch.Tensor  # (C,) int64, on the index's device
    twin: torch.Tensor     # (C,) int64


def shard_index(mesh: Mesh, index: map_stage.ContigIndex,
                k: int) -> ShardedContigIndex:
    """Split the dense sorted index at the routed lookup's owner
    boundaries (the index is condensed-graph-sized, orders below the
    read set)."""
    d = mesh.d
    n = index.n
    bounds = sharded_count.owner_bounds_tensor(k, d).to(index.keys.device)
    splits = torch.searchsorted(index.keys[:n, 0].contiguous(), bounds)
    starts = [0] + splits.tolist() + [n]
    per = [b - a for a, b in zip(starts, starts[1:])]
    cap = max(max(per), 1)
    payload = torch.stack([index.ctg, index.pos,
                           index.is_rc.to(torch.int64)], -1)

    def shard(s):
        dev = mesh.devices[s]
        pad = cap - per[s]
        rows = slice(starts[s], starts[s + 1])
        keys = mesh.to_shard(index.keys[rows], s)
        pay = mesh.to_shard(payload[rows], s)
        return (torch.cat([keys, keys.new_full((pad, keys.shape[1]),
                                               dictionary.SENTINEL)]),
                torch.cat([pay, pay.new_full((pad, 3), -1)]),
                torch.zeros(cap, dtype=torch.bool, device=dev))

    keys, pay, deleted = zip(*mesh.map(shard))
    return ShardedContigIndex(list(keys), list(pay), per, list(deleted),
                              index.ctg_len, index.twin)


def map_reads_sharded(mesh: Mesh, sidx: ShardedContigIndex, seqs, lengths,
                      k: int, map_len: int = 32
                      ) -> map_stage.ReadPlacements:
    """Sharded twin of stages/map.map_reads — the same ReadPlacements
    contract (flat arrays in batch-row read order), on the first
    shard's device.  seqs (R, L) uint8 / lengths (R,): host arrays; the
    rows are split into D contiguous blocks, the last ones padded with
    empty reads, which are dropped from the result."""
    r0, l = seqs.shape
    p = l - k + 1
    router = sharded_graph.Router(mesh, sidx.keys[0].shape[0])
    seqs_d = mesh.split_rows(seqs, fill=4)
    lens_d = mesh.split_rows(lengths, fill=0)
    r_loc = seqs_d[0].shape[0]

    streams = mesh.map(lambda s, sq, ln: kmer.chop_reads(sq, ln, k),
                       seqs_d, lens_d)
    rows = router.lookup(
        sidx.keys, sidx.n, sidx.deleted,
        [torch.where(x.valid[:, None], x.kmers, dictionary.SENTINEL)
         for x in streams], k=k)
    got = router.gather(sidx.payload, rows)

    def vote(s, row, g, x, lens, ctg_len, twin):
        hit = row >= 0
        pl = map_stage.vote(
            torch.where(hit, g[:, 0], -1).view(r_loc, p),
            torch.where(hit, g[:, 1], 0).view(r_loc, p),
            (hit & (g[:, 2] > 0)).view(r_loc, p), x.is_rc.view(r_loc, p),
            lens, ctg_len, twin, k, map_len)
        # lift the local read ids to batch-row ids
        return pl._replace(g_read=pl.g_read + s * r_loc)

    parts = mesh.map(vote, rows, got, streams, lens_d,
                     mesh.replicate(sidx.ctg_len), mesh.replicate(sidx.twin))

    def whole(field, per_read: bool):
        x = mesh.gather_rows([getattr(pl, field) for pl in parts])
        # drop the padding rows (they carry no valid group: length 0)
        return x[:r0] if per_read else x[:r0 * p]

    return map_stage.ReadPlacements(*(
        whole(f, not f.startswith("g_"))
        for f in map_stage.ReadPlacements._fields))
