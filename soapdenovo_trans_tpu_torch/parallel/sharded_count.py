"""K-mer counting over a mesh of shards.

Port of ``soapdenovo_trans_tpu/parallel/sharded_count.py``.  Reads are
DATA-parallel over the mesh, the k-mer table is SPACE-sharded by key
prefix; a table too large for one device lives in the memory of all of
them.  The routed counting step and the persistent per-shard
accumulation:

    for every shard (parallel/mesh.py):
      1. chop the local read block -> canonical k-mer stream  (local)
      2. owner = inverse-CDF split of the key's top word      (local)
      3. bucket the packed rows by owner                      (one sort)
      4. ``mesh.all_to_all`` routes the rows to their owners  (exchange)
      5. the owner sorts + dedups what it received            (local)

    a per-shard LSM merge (``merge_sharded``) accumulates batch tables
    INTO the resident shard — the table is not gathered while counting;
    coverage splitting happens once at the end (``finalize_sharded``).

which replaces the reference's "every worker scans the whole shared
buffer and takes its own" scheme (prlHashReads.c:79-92).  Prefix
sharding keeps each shard's keys a contiguous sorted range, so a global
lookup is: route the query to its owner (same split points) + the
owner's local lookup (sharded_graph.Router.lookup — the search_kmerset
analog, src/newhash.c:239-283).

Canonical keys skew low (min of value and revcomp); the shard
boundaries are the analytic inverse-CDF split points (see
``_owner_boundaries``), so the expected shard mass is equal.  Buckets
are exact, so residual skew costs balance, never a retry: the JAX
package's bucket capacity and ``dropped`` counter are gone.

The per-shard merge is ``dictionary.merge_packed``: two-lane rows
(K <= 28) on a CUDA device go through the merge-path kernel, where the
JAX package re-sorts the concatenation (same rows, same counts).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from ..ops import bits, dictionary, kmer
from .mesh import Mesh, Sharded


class ShardedPacked(NamedTuple):
    """Per-shard deduped (k-mer, context) rows resident on the mesh:
    shard ``s`` is the ``PackedTable`` (rows[s], count[s], n[s])."""

    rows: Sharded   # (max(n, 1), WP) int64 lanes, each shard ascending
    count: Sharded  # (max(n, 1),) int32
    n: List[int]    # live rows per shard


class ShardedTable(NamedTuple):
    """Per-shard finalized k-mer table (global order = shard-major).
    Every shard holds ``cap`` rows, rows [0, n[s]) live and the rest
    sentinels: global row ``s * cap + i`` is row i of shard s."""

    keys: Sharded   # (cap, W) int64 lanes, each shard ascending
    count: Sharded  # (cap,) int32
    l_cov: Sharded  # (cap, 4) int32
    r_cov: Sharded  # (cap, 4) int32
    n: List[int]    # live rows per shard

    @property
    def cap(self) -> int:
        return self.keys[0].shape[0]


def _owner_boundaries(k: int, n_shards: int) -> np.ndarray:
    """Equal-mass split points over word 0 of a canonical key.

    A canonical k-mer is min(x, revcomp(x)); for uniform x its
    normalized value p has density 2(1-p), CDF F(p) = 2p - p^2, so raw
    top-bit prefix shards skew ~2x toward shard 0.  The inverse-CDF
    boundaries p_i = 1 - sqrt(1 - i/d) balance the expected mass while
    keeping the owner function monotone in the key — each shard still
    owns a contiguous sorted key range (gather stays a concatenation).
    The float arithmetic is the JAX package's, term for term: the owner
    of every key depends on these values.
    """
    w = bits.words_for_k(k)
    used = 2 * k - 32 * (w - 1)  # live bits in the top word
    top = float(1 << used)
    return np.asarray(
        [min(int((1.0 - math.sqrt(1.0 - i / n_shards)) * top),
             (1 << used) - 1)
         for i in range(1, n_shards)], dtype=np.uint32)


def owner_bounds_tensor(k: int, n_shards: int) -> torch.Tensor:
    """The split points as (D - 1,) int64 for ``torch.bucketize``."""
    return torch.from_numpy(
        _owner_boundaries(k, n_shards).astype(np.int64))


def owner_of(key_word0: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Owner shard of keys by their word 0: the number of split points
    at or below it."""
    return torch.bucketize(key_word0.contiguous(),
                           bounds.to(key_word0.device), right=True)


def count_step(mesh: Mesh, seqs: Sharded, lengths: Sharded,
               k: int) -> ShardedPacked:
    """One batch: every shard chops its read block, the packed rows
    (key + valid/prev/next bits, dictionary.pack_stream) move to their
    owners in one exchange, every owner sorts and dedups what it got.
    seqs: (r, L) uint8 a shard, lengths: (r,)."""
    d = mesh.d
    bounds = owner_bounds_tensor(k, d)

    def chop(j, seqs_j, lens_j):
        stream = kmer.chop_reads(seqs_j, lens_j, k)
        owner = owner_of(stream.kmers[:, 0], bounds)
        return torch.where(stream.valid, owner, d), dictionary.pack_stream(
            stream.kmers, stream.prev, stream.next, stream.valid, k)

    # an invalid window goes to no shard
    owner, packed = zip(*mesh.map(chop, seqs, lengths))
    recv = mesh.send(mesh.route(owner), packed)

    def reduce(s):
        rows, = dictionary.sort_rows(torch.cat(recv[s]))
        return dictionary.packed_from_sorted(
            rows, torch.ones(rows.shape[0], dtype=torch.int32,
                             device=rows.device))

    return _from_tables(mesh.map(reduce))


def _tables(sp: ShardedPacked) -> List[dictionary.PackedTable]:
    return [dictionary.PackedTable(*x) for x in zip(*sp)]


def _from_tables(tables) -> ShardedPacked:
    return ShardedPacked(*(list(x) for x in zip(*tables)))


def merge_sharded(mesh: Mesh, a: ShardedPacked,
                  b: ShardedPacked) -> ShardedPacked:
    """Per-shard LSM merge step: combines two mesh-resident
    accumulations WITHOUT gathering — each shard merges its own sorted
    row range locally (the persistent-residency analogue of put_kmerset
    updating the thread-local KmerSet, src/newhash.c:411-462)."""
    return _from_tables(mesh.map(
        lambda s, ta, tb: dictionary.merge_packed(ta, tb),
        _tables(a), _tables(b)))


def with_cap(st: ShardedTable, cap: int) -> ShardedTable:
    """The same table with every shard padded (or cut) to ``cap`` rows;
    ``cap`` must hold every shard's live rows.  Global row ids change
    with it, nothing else does."""
    if cap < max(max(st.n), 1):
        raise ValueError(f"cap {cap} is below a shard's {max(st.n)} rows")

    def fit(x, fill):
        x = x[:cap]
        pad = x.new_full((cap - x.shape[0],) + x.shape[1:], fill)
        return torch.cat([x, pad])

    return ShardedTable(
        [fit(x, dictionary.SENTINEL) for x in st.keys],
        [fit(x, 0) for x in st.count], [fit(x, 0) for x in st.l_cov],
        [fit(x, 0) for x in st.r_cov], list(st.n))


def finalize_sharded(mesh: Mesh, sp: ShardedPacked, k: int) -> ShardedTable:
    """Per-shard coverage split: mesh-resident ShardedPacked ->
    ShardedTable, one local finalize a shard (counters capped at
    MAX_KMER_COV there), then every shard padded to the common
    capacity, the largest shard's row count."""
    tables = mesh.map(lambda s, pt: dictionary.finalize(pt, k), _tables(sp))
    st = ShardedTable([t.keys for t in tables], [t.count for t in tables],
                      [t.l_cov for t in tables], [t.r_cov for t in tables],
                      [t.n for t in tables])
    return with_cap(st, max(max(st.n), 1))


def gather_to_table(mesh: Mesh, st: ShardedTable,
                    device=None) -> dictionary.KmerTable:
    """Concatenate the shards' live ranges into one KmerTable on
    ``device`` (default: the first shard's).  Prefix sharding makes the
    shard-major concatenation globally sorted.  For callers that go on
    with one device; counting itself never gathers."""
    if isinstance(st, ShardedPacked):
        raise TypeError("finalize_sharded before gather_to_table")
    n_tot = sum(st.n)

    def live(xs, fill):
        out = mesh.gather_rows([x[:n] for x, n in zip(xs, st.n)], device)
        if n_tot:
            return out
        return out.new_full((1,) + out.shape[1:], fill)

    keys = live(st.keys, dictionary.SENTINEL)
    return dictionary.KmerTable(
        keys, live(st.count, 0), live(st.l_cov, 0), live(st.r_cov, 0),
        n_tot, torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device))
