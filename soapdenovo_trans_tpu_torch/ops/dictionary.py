"""Sorted k-mer dictionary: the run path of the k-mer "hash table".

Port of ``soapdenovo_trans_tpu/ops/dictionary.py``: the counting run
path (``SortedRun``), the deduplicated accumulation format
(``PackedTable``) and lookup.  The streaming unit is a PACKED ROW,
``key<<7 | 1<<6 | prev<<3 | next`` in ``ceil((2K+7)/32)`` lanes (2 for
K <= 28): the k-mer with its left/right base context in one sortable
integer.  A build unit is one chop + pack + sort (a ``SortedRun``);
runs merge through the merge-path kernel with no host sync; one dedup
and one finalize at the end split each key's context rows into the
reference's per-base coverage counters (src/inc/newhash.h:38-53,
saturating at MAX_KMER_COV=63 — summing exactly and capping once is
the same thing).

Capacities are exact: a table holds ``max(n, 1)`` rows, where the JAX
package rounds up to 128 or a power of two to bound its compile count.
Invalid rows are all-ones sentinels; a real row always has a zero high
bit (2K+7 < 32*WP), so no real row equals the sentinel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import merge_path
from . import bits, kmer

MAX_KMER_COV = 63  # reference: src/inc/newhash.h:30
SENTINEL = bits.LANE_MASK  # every lane of a sentinel row


class KmerTable(NamedTuple):
    """Sorted unique canonical k-mers + de Bruijn node payload.

    Rows [0, n) are real entries in ascending key order; a table with
    no entries holds one sentinel row."""

    keys: torch.Tensor     # (cap, W) int64 lanes, ascending
    count: torch.Tensor    # (cap,) int32 occurrence count (not capped)
    l_cov: torch.Tensor    # (cap, 4) int32 left-extension coverage, capped 63
    r_cov: torch.Tensor    # (cap, 4) int32 right-extension coverage, capped 63
    n: int                 # number of real entries
    deleted: torch.Tensor  # (cap,) bool — node removed by a cleaning pass

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


class SortedRun(NamedTuple):
    """Sorted (possibly duplicate-bearing) packed rows with counts.

    Equal rows may repeat, each carrying a count.  ``n`` is a device
    scalar: reading it is deferred so the build/merge pipeline never
    waits on the host."""

    rows: torch.Tensor   # (cap, WP) int64 lanes ascending; sentinel-padded
    count: torch.Tensor  # (cap,) int32 multiplicity per row
    n: torch.Tensor      # () int64 live rows (device scalar)

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


class PackedTable(NamedTuple):
    """Deduplicated (k-mer, context) rows: the accumulation format of
    the batch-by-batch build (``build_packed`` + ``merge_packed`` +
    ``finalize``).  Rows [0, n) are distinct packed rows in ascending
    order with their multiplicities; an empty table holds one sentinel
    row.  Every build and merge reads ``n`` on the host."""

    rows: torch.Tensor   # (cap, WP) int64 lanes, ascending
    count: torch.Tensor  # (cap,) int32 multiplicity of each distinct row
    n: int               # number of real rows

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


def _is_sentinel(rows: torch.Tensor) -> torch.Tensor:
    return (rows == SENTINEL).all(-1)


def sort_rows(rows: torch.Tensor, *payload):
    """Sort rows ascending by their multiword value; payload reordered
    along (JAX: ``_sort_by_keys`` and the ``num_keys=w`` sorts).  Two-lane
    rows sort as one folded int64 key."""
    if rows.shape[-1] == 2:
        srt = torch.sort(bits.fold2(rows), stable=True)
        return (bits.unfold2(srt.values),) + tuple(
            p[srt.indices] for p in payload)
    order = bits.lex_order(rows)
    return (rows[order],) + tuple(p[order] for p in payload)


def packed_width_k(k: int) -> int:
    """Tight packed-row width for K: lanes for 2K key bits + 7 payload
    bits; always leaves a zero high bit in real rows."""
    return (2 * k + 7 + 31) // 32


def pack_stream(keys, prev, nxt, valid, k: int) -> torch.Tensor:
    """Fold the 7-bit per-kmer payload (valid:1, prev:3, next:3) into
    the low bits of the widened key -> (n, WP) rows; invalid rows
    become all-ones sentinels."""
    payload = (valid.to(torch.int64) << 6) | \
        (prev.to(torch.int64) << 3) | nxt.to(torch.int64)
    packed = bits.shl_const(bits.widen(keys, packed_width_k(k)), 7)
    packed[..., -1] |= payload
    return torch.where(valid[:, None], packed, SENTINEL)


def unpack_rows(rows: torch.Tensor, k: int):
    """Packed rows -> (keys (n, W), prev (n,), next (n,), valid (n,))."""
    w = bits.words_for_k(k)
    wp = rows.shape[-1]
    last = rows[..., -1]
    keys = bits.shr_const(rows, 7)[..., wp - w:]
    valid = ((last >> 6) & 1).to(torch.bool) & ~_is_sentinel(rows)
    return keys, ((last >> 3) & 7).to(torch.uint8), \
        (last & 7).to(torch.uint8), valid


def sorted_run_from_reads(seqs: torch.Tensor, lengths: torch.Tensor,
                          k: int) -> SortedRun:
    """One build unit: reads -> sorted run (chop + pack + sort).  No
    host sync."""
    stream = kmer.chop_reads(seqs, lengths, k)
    rows, = sort_rows(pack_stream(
        stream.kmers, stream.prev, stream.next, stream.valid, k))
    cnt = (~_is_sentinel(rows)).to(torch.int32)
    return SortedRun(rows, cnt, cnt.sum(dtype=torch.int64))


def pack_host_reads(codes, lengths):
    """The host half of a build unit that uploads packed: 2-bit pack
    (ops/readpack.py), or the raw codes if the batch holds too many N.
    Pure numpy, so a caller may run it beside the device's work."""
    from . import readpack

    codes = np.asarray(codes)
    lengths = np.asarray(lengths)
    if lengths.max(initial=0) < 2**15:
        lengths = lengths.astype(np.int16)
    pr = readpack.pack_reads(codes)
    if pr is None:
        return ("raw", codes, lengths)
    return ("packed", pr.data, pr.n_flat, lengths, pr.l)


def put_prepped(packed, device):
    """The upload half of a build unit (see ``pack_host_reads``)."""
    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if packed[0] == "raw":
        _, codes, lengths = packed
        return ("raw", put(codes), put(lengths))
    _, data, n_flat, lengths, l = packed
    return ("packed", put(data), put(n_flat), put(lengths), l)


def sorted_run_from_prepped(prepped, k: int) -> SortedRun:
    """Device build from ``put_prepped``'s output.  No host sync."""
    from . import readpack

    if prepped[0] == "raw":
        _, codes, lengths = prepped
    else:
        _, data, n_flat, lengths, l = prepped
        codes = readpack.unpack_reads(data, n_flat, l)
    return sorted_run_from_reads(codes, lengths, k)


def sorted_run_from_host_reads(codes, lengths, k: int, device) -> SortedRun:
    """pack + upload + build of one unit of host reads."""
    return sorted_run_from_prepped(
        put_prepped(pack_host_reads(codes, lengths), device), k)


def _concat_sort(a, b):
    """The plain merge of two runs or tables: concatenate and sort."""
    return sort_rows(torch.cat([a.rows, b.rows]),
                     torch.cat([a.count, b.count]))


def _merge_rows(a, b):
    """(rows, count) of two sorted runs or tables merged, duplicates
    kept.  Two-lane rows (K <= 28) go through the merge-path kernel;
    wider rows through concat + sort, as in the JAX package."""
    if a.rows.shape[-1] == 2:
        return merge_path.merge_sorted_rows(
            a.rows, a.count, b.rows, b.count, a.n, b.n)
    return _concat_sort(a, b)


def merge_runs(a: SortedRun, b: SortedRun) -> SortedRun:
    """Combine two sorted runs without dedup compaction.  No host
    sync."""
    rows, count = _merge_rows(a, b)
    return SortedRun(rows, count, a.n + b.n)


def _dedup_sorted(rows: torch.Tensor, count: torch.Tensor):
    """Dedup an already-sorted, sentinel-tailed row array: equal rows
    sum their counts; returns exactly the distinct live rows."""
    svalid = ~_is_sentinel(rows)
    last = svalid.clone()
    last[:-1] &= (rows[1:] != rows[:-1]).any(-1)
    c_end = torch.cumsum(torch.where(svalid, count, 0), 0)[last]
    count_c = torch.diff(c_end, prepend=c_end.new_zeros(1))
    return rows[last], count_c.to(torch.int32)


def _pad_to_one(x: torch.Tensor, fill) -> torch.Tensor:
    """A zero-row result keeps one fill row (capacity max(n, 1))."""
    if x.shape[0]:
        return x
    return torch.full((1,) + x.shape[1:], fill, dtype=x.dtype,
                      device=x.device)


def collapse_run(run: SortedRun) -> SortedRun:
    """Dedup-compact a run (equal rows summed, uniques only).  The one
    host sync of the run pipeline."""
    rows, count = _dedup_sorted(run.rows, run.count)
    n = rows.shape[0]
    return SortedRun(_pad_to_one(rows, SENTINEL), _pad_to_one(count, 0),
                     torch.tensor(n, device=rows.device))


class RunAccumulator:
    """Binary counter over SortedRuns, merged on capacity rank; folds
    and dedups into a compacted base whenever accumulated capacity
    would exceed ``collapse_rows`` (bounds device memory)."""

    def __init__(self, collapse_rows: int = 192_000_000):
        self.runs: list = []
        self.collapse_rows = collapse_rows

    def insert(self, r: SortedRun) -> None:
        self.runs.append(r)
        while (len(self.runs) >= 2 and
               self.runs[-2].capacity <= 2 * self.runs[-1].capacity):
            b = self.runs.pop()
            a = self.runs.pop()
            self.runs.append(merge_runs(a, b))
        if sum(x.capacity for x in self.runs) >= self.collapse_rows:
            self.runs = [collapse_run(self._fold())]

    def _fold(self) -> SortedRun:
        acc = self.runs[0]
        for x in self.runs[1:]:
            acc = merge_runs(acc, x)
        return acc

    def finish(self) -> SortedRun | None:
        if not self.runs:
            return None
        return self._fold()


def _finalize(rows: torch.Tensor, count: torch.Tensor, k: int):
    """Split sorted context rows into per-key count + l/r per-base
    coverage.  Each key's context rows are contiguous (the key is in
    the high bits); the counters are segment sums over key runs."""
    live = ~_is_sentinel(rows)
    rows, count = rows[live], count[live].to(torch.int64)
    w = bits.words_for_k(k)
    keys = bits.shr_const(rows, 7)[:, rows.shape[-1] - w:]
    head = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    head[1:] = (keys[1:] != keys[:-1]).any(-1)
    seg = torch.cumsum(head, 0) - 1
    n = int(head.sum())
    uniq = keys[head]
    count_u = count.new_zeros(n).index_add_(0, seg, count)

    def cov(ctx):  # ctx: 0..3 base, 4 none
        flat = count.new_zeros(n * 8).index_add_(0, seg * 8 + ctx, count)
        return flat.view(n, 8)[:, :4]

    last_lane = rows[:, -1]
    return uniq, count_u, cov((last_lane >> 3) & 7), cov(last_lane & 7), n


def _fit_table(uniq_keys, count, l_cov, r_cov, n: int) -> KmerTable:
    """Exact-capacity table: counters capped once at MAX_KMER_COV."""
    return KmerTable(
        _pad_to_one(uniq_keys, SENTINEL),
        _pad_to_one(count.to(torch.int32), 0),
        _pad_to_one(l_cov.clamp(0, MAX_KMER_COV).to(torch.int32), 0),
        _pad_to_one(r_cov.clamp(0, MAX_KMER_COV).to(torch.int32), 0),
        n,
        torch.zeros(max(n, 1), dtype=torch.bool, device=uniq_keys.device))


def finalize_run(run: SortedRun, k: int) -> KmerTable:
    """Accumulated run -> KmerTable: dedup (one sync) keeps the
    coverage split at compacted size, then split contexts."""
    c = collapse_run(run)
    return _fit_table(*_finalize(c.rows, c.count, k))


def packed_from_sorted(rows: torch.Tensor,
                       count: torch.Tensor) -> PackedTable:
    """Sorted rows with counts -> PackedTable (dedup, one host sync)."""
    rows, count = _dedup_sorted(rows, count)
    return PackedTable(_pad_to_one(rows, SENTINEL), _pad_to_one(count, 0),
                       rows.shape[0])


def build_packed(stream: kmer.KmerStream, k: int) -> PackedTable:
    """One batch of the batch-by-batch build: KmerStream -> PackedTable
    (the per-batch analogue of put_kmerset's insert loop,
    src/newhash.c:411-462)."""
    rows, = sort_rows(pack_stream(
        stream.kmers, stream.prev, stream.next, stream.valid, k))
    return packed_from_sorted(rows, (~_is_sentinel(rows)).to(torch.int32))


def build_packed_from_reads(seqs: torch.Tensor, lengths: torch.Tensor,
                            k: int) -> PackedTable:
    """chop -> pack -> sort -> dedup of one read batch."""
    return build_packed(kmer.chop_reads(seqs, lengths, k), k)


def build_packed_from_reads_many(batches, k: int) -> list:
    """``build_packed_from_reads`` over several (seqs, lengths)
    batches."""
    return [build_packed_from_reads(s, l, k) for s, l in batches]


def merge_packed(a: PackedTable, b: PackedTable) -> PackedTable:
    """Combine two PackedTables: merge + dedup (equal rows summed)."""
    return packed_from_sorted(*_merge_rows(a, b))


def merge_packed_plain(a: PackedTable, b: PackedTable) -> PackedTable:
    """``merge_packed`` through concat + sort whatever the row width and
    the device: what the kernel path is held against."""
    return packed_from_sorted(*_concat_sort(a, b))


def finalize(pt: PackedTable, k: int) -> KmerTable:
    """Accumulated PackedTable -> KmerTable (once per counting phase)."""
    return _fit_table(*_finalize(pt.rows, pt.count, k))


def merge_finalize(a: PackedTable, b: PackedTable, k: int) -> KmerTable:
    """The last merge fused with finalize: the dedup between them is
    skipped, since ``_finalize`` sums per key and so absorbs duplicate
    (k-mer, context) rows."""
    return _fit_table(*_finalize(*_merge_rows(a, b), k))


def merge_finalize_plain(a: PackedTable, b: PackedTable,
                         k: int) -> KmerTable:
    """``merge_finalize`` through concat + sort (see
    ``merge_packed_plain``)."""
    return _fit_table(*_finalize(*_concat_sort(a, b), k))


def build(stream: kmer.KmerStream, k: int) -> KmerTable:
    """Single-shot build: KmerStream -> KmerTable (small inputs)."""
    return finalize(build_packed(stream, k), k)


def _fold_keys(lanes: torch.Tensor) -> torch.Tensor:
    return lanes[..., 0] if lanes.shape[-1] == 1 else bits.fold2(lanes)


def lookup(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Vectorized multiword lookup: (M,) int64 row index or -1
    (reference search_kmerset, src/newhash.c:239-283).  Keys of up to
    two lanes fold to one int64 for ``searchsorted``; wider keys run a
    branchless bisection over the lanes."""
    cap, w = keys.shape
    if w <= 2:
        kf = _fold_keys(keys)
        qf = _fold_keys(queries)
        lo = torch.searchsorted(kf, qf)
        hit = (lo < cap) & (kf[lo.clamp(max=cap - 1)] == qf)
        return torch.where(hit, lo, -1)
    m = queries.shape[0]
    lo = torch.zeros(m, dtype=torch.int64, device=keys.device)
    hi = torch.full((m,), cap, dtype=torch.int64, device=keys.device)
    for _ in range(cap.bit_length()):
        live = lo < hi
        mid = (lo + hi) >> 1
        less = bits.lex_less(keys[mid.clamp(max=cap - 1)], queries)
        lo = torch.where(live & less, mid + 1, lo)
        hi = torch.where(live & ~less, mid, hi)
    hit = (lo < cap) & bits.lex_eq(keys[lo.clamp(max=cap - 1)], queries)
    return torch.where(hit, lo, -1)
