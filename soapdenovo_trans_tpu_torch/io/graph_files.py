"""Reference-format graph files: .vertex / .edge.gz / .preArc
(pregraph -> contig boundary) and .updated.edge / .Arc (contig ->
scaff boundary).

A jax-free copy of ``write_pregraph_files``, ``edge_file_ids``,
``load_pregraph_files``, ``write_contig_graph_files``,
``load_contig_graph_files`` and the hex helpers of
``soapdenovo_trans_tpu/io/graph_files.py``, which imports ``jax`` at
module level; the machine that runs the port on the GPU has no jax.  The
writers take the port's tensors and read them on the host; the loaders
return the port's state on a given device.

* .vertex  — branch-kmer hex dump, 8 per line (reference
  output_pregraph.c:47-81, print_kmer kmer.c:499-516); the loader
  canonicalizes and sorts (loadPreGraph.c:52-122);
* .edge.gz — one record per canonical edge pair:
  ``>length L,<from kmer hex>,<to kmer hex>,cvg C, B`` + sequence
  (100/line) (output_pregraph.c:83-100); the loader materializes the
  reverse-complement twin right after each B==1 record
  (loadPreGraph.c:306-541);
* .preArc  — ``from to1 m1 to2 m2 ...`` with 1-based edge ids
  (prlRead2path.c output_arcs, loadPreGraph.c:629-670);
* .updated.edge — ``EDGEs n`` + per contig
  ``>length L,S,C <from hex>,<to hex>,`` where S is 1/-1/0 for
  smaller-than-twin / larger / palindrome and L includes the K overlap
  (output_contig.c:289-336);
* .Arc — ``i to1 m1 ...`` in contig ids, wrapped every 10 pairs
  (output_contig.c:336-380).

Hex follows the compile-time MER variant the reference would use for
this K: one u64 for K<=31, "high low" for K<=63, four words for K<=127.

The pregraph writer builds each of its three files as one ``np.uint8``
buffer by whole-array operations, with no loop over records or bases:
every field is an (n, width) byte column, as wide as its largest value,
with a mask that drops leading zeros (and a literal's absent cases); a
file is the columns' row-major boolean compaction.  ``.edge.gz`` places
its headers and its bases (a 4-byte lookup of the pool) by index
arithmetic, every other byte a newline, in blocks of records of about
a million bases, each block's text written on into one level-9 gzip
member; ``.preArc`` groups the arc rows by a stable sort on the
from-edge's file id.

That member is deflated as pigz does it (``_GzipMember``): the text is
cut at fixed offsets into chunks of ``_CHUNK`` bytes, each chunk raw
deflate at level 9 primed with the ``_WINDOW`` bytes of text before it,
ended by a sync flush (the last by the final block), on a pool of one
thread a host core (zlib frees the GIL while it compresses) while the
main thread builds the next block's text.  The chunks' streams, written
in order between a fixed 10-byte header (no name, MTIME 0, XFL 2: the
slowest level) and the trailer (the text's crc32 and length), are one
deflate stream: the file's bytes depend on the text alone, not on the
host's cores or the clock.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from ..ops import bits, dictionary
from ..utils import profiling


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def _n_u64(k: int) -> int:
    return 1 if k <= 31 else (2 if k <= 63 else 4)


def _lanes_to_int(lanes) -> int:
    v = 0
    for x in lanes:
        v = (v << 32) | int(x)
    return v


def _int_to_lanes(v: int, w: int) -> List[int]:
    return [(v >> (32 * (w - 1 - i))) & 0xFFFFFFFF for i in range(w)]


def _kmer_hex(lanes, k: int) -> str:
    """print_kmer text for one kmer (kmer.c:499-516)."""
    v = _lanes_to_int(lanes)
    n = _n_u64(k)
    if n == 1:
        return f"{v:x}" if v else "0x0"  # MER31 zero quirk
    words = [(v >> (64 * (n - 1 - i))) & ((1 << 64) - 1) for i in range(n)]
    return " ".join(f"{wv:x}" for wv in words)


def _revcomp_int(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((v & 3) ^ 2)
        v >>= 2
    return out


# -- text as byte columns ------------------------------------------------
# A field of n records is an (n, width) uint8 table and a mask of the
# bytes it keeps; a record's text is its row of the concatenated
# columns, masked bytes dropped, so a file is one boolean compaction.

_HEX_DIGITS = np.frombuffer(b"0123456789abcdef", np.uint8)
_BASE_BYTES = np.frombuffer(bits.BASE_CHARS.encode(), np.uint8)
_BLOCK_BASES = 1 << 20


def _lit(text: bytes, n: int, where=None):
    """A literal in every record, or only where ``where`` holds."""
    chars = np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text)))
    keep = np.ones((n, 1), bool) if where is None else where[:, None]
    return chars, np.broadcast_to(keep, chars.shape)


def _digits(d: np.ndarray):
    """(n, w) digit values, most significant first -> their characters
    without leading zeros (the last digit always kept), the columns no
    record keeps cut off."""
    keep = np.logical_or.accumulate(d != 0, axis=1)
    keep[:, -1] = True
    first = int(np.argmax(keep.any(0)))
    return _HEX_DIGITS[d[:, first:]], keep[:, first:]


def _dec(v: np.ndarray, where=None) -> list:
    """Decimal columns of int64 ``v`` (``str(int)``), as wide as its
    largest value; only where ``where`` holds, if given."""
    v = np.asarray(v, np.int64)
    mag = np.abs(v)
    width = len(str(int(mag.max()))) if mag.size else 1
    pow10 = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    chars, keep = _digits((mag[:, None] // pow10) % 10)
    cols = [_lit(b"-", v.shape[0], v < 0), (chars, keep)]
    if where is not None:
        cols = [(c, k & where[:, None]) for c, k in cols]
    return cols


def _hex(lanes: np.ndarray, k: int) -> list:
    """print_kmer columns of (n, W) k-mer lanes (kmer.c:499-516), as
    ``_kmer_hex`` writes one: ``_n_u64(k)`` 64-bit words, each lowercase
    without leading zeros, a space between words; ``0x0`` for a zero
    k-mer in the one-word form (the MER31 quirk)."""
    n, w = lanes.shape
    nu = _n_u64(k)
    padded = np.zeros((n, 2 * nu), np.int64)
    padded[:, 2 * nu - w:] = lanes
    nib = (padded[:, :, None] >> np.arange(28, -1, -4)) & 15
    nib = nib.reshape(n, nu, 16)
    cols = [_lit(b"0x", n, ~nib[:, 0].any(1))] if nu == 1 else []
    for i in range(nu):
        if i:
            cols.append(_lit(b" ", n))
        cols.append(_digits(nib[:, i]))
    return cols


def _records(cols: list):
    """Concatenate the columns record by record, drop the masked bytes:
    (the records' text as one uint8 buffer, each record's length)."""
    chars = np.concatenate([c for c, _ in cols], axis=1)
    keep = np.concatenate([k for _, k in cols], axis=1)
    return chars[keep], keep.sum(1)


def _oriented_lanes(keys: torch.Tensor, nodes: torch.Tensor,
                    k: int) -> np.ndarray:
    """Directed node ids (2*row + s) -> oriented k-mer lanes, (n, W), on
    the host: the table row, reverse-complemented where s is set; the
    gather runs where ``keys`` and ``nodes`` are."""
    km = keys[nodes.clamp(min=0) >> 1]
    rc = ((nodes & 1) == 1)[:, None]
    return torch.where(rc, bits.reverse_complement(km, k), km).cpu().numpy()


# -- .edge.gz: one gzip member, deflated in chunks in parallel ------------

_CHUNK = 1 << 18   # bytes of text a deflate chunk
_WINDOW = 1 << 15  # deflate's window: the text a chunk is primed with
_IN_FLIGHT = 2     # chunks queued or deflating, a worker
_GZIP_HEADER = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 2, 255])


def _deflate_workers() -> int:
    """The host cores this process may run on."""
    return len(os.sched_getaffinity(0))


def _deflate(primer, chunk, last: bool) -> bytes:
    """One chunk as raw level-9 deflate, primed with the text before it
    (none before the first), ended byte-aligned by a sync flush, or by
    the final block if it is the last."""
    z = zlib.compressobj(9, zlib.DEFLATED, -15, 9,
                         **({"zdict": primer} if len(primer) else {}))
    return z.compress(chunk) + z.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


class _GzipMember:
    """One level-9 gzip member written to ``fh`` as pigz writes one: the
    text given to ``write`` is cut at fixed offsets into chunks of
    ``_CHUNK`` bytes, a chunk cut only once text follows it, so the last
    is known; ``close`` deflates the last and writes the trailer.  From
    the second chunk on the chunks deflate on a pool of up to one thread
    a core, at most ``_IN_FLIGHT`` a worker queued or running, and the
    main thread writes their streams in order; one chunk, or one core,
    deflates inline.  The crc runs on over each chunk as it is cut.  The
    pool lives inside the ``with`` of its user.  Counters
    ``pregraph.write.edge.{chunks,workers,text_bytes,gz_bytes}``."""

    def __init__(self, fh):
        self._fh, self._cores = fh, _deflate_workers()
        self._stack = contextlib.ExitStack()
        self._pool, self._queue = None, collections.deque()
        self._buf, self._at = np.zeros(0, np.uint8), 0  # window + uncut
        self._crc = self._text = self._chunks = 0
        self._gz = self._emit(_GZIP_HEADER)

    def __enter__(self) -> "_GzipMember":
        return self

    def __exit__(self, *exc) -> bool:
        self._stack.close()
        return False

    def _emit(self, data: bytes) -> int:
        self._fh.write(data)
        return len(data)

    def _cut(self, end: int, last: bool) -> None:
        at = self._at
        primer, chunk = self._buf[max(at - _WINDOW, 0):at], self._buf[at:end]
        self._crc = zlib.crc32(chunk, self._crc)
        self._text += len(chunk)
        self._chunks += 1
        self._at = end
        if self._pool is None and self._cores > 1 and not last:
            self._pool = self._stack.enter_context(
                ThreadPoolExecutor(self._cores))
        if self._pool is None:
            self._gz += self._emit(_deflate(primer, chunk, last))
            return
        self._queue.append(self._pool.submit(_deflate, primer, chunk, last))
        while len(self._queue) > _IN_FLIGHT * self._cores or (
                last and self._queue):
            self._gz += self._emit(self._queue.popleft().result())

    def write(self, text: np.ndarray) -> None:
        self._buf = np.concatenate([self._buf, text])
        while self._buf.shape[0] - self._at > _CHUNK:
            self._cut(self._at + _CHUNK, False)
        keep = max(self._at - _WINDOW, 0)
        self._buf, self._at = self._buf[keep:], self._at - keep

    def close(self) -> None:
        self._cut(self._buf.shape[0], True)
        self._gz += self._emit(struct.pack(
            "<II", self._crc, self._text & 0xFFFFFFFF))
        workers = min(self._cores, self._chunks) if self._pool else 1
        for name, value in (("chunks", self._chunks), ("workers", workers),
                            ("text_bytes", self._text),
                            ("gz_bytes", self._gz)):
            profiling.counter("pregraph.write.edge." + name, value)


def _edge_text(head_cols: list, ln: np.ndarray, seq_off: np.ndarray,
               pool: np.ndarray) -> np.ndarray:
    """The .edge.gz text of some records: each its header, then its
    bases 100 a line (a 4-byte lookup of the pool), each line ended by
    a newline, one empty line for no bases; every byte that is neither
    a header's nor a base's is a newline."""
    head, head_len = _records(head_cols)
    n_lines = np.maximum((ln + 99) // 100, 1)
    rec_len = head_len + ln + n_lines
    rec_at = np.cumsum(rec_len) - rec_len
    buf = np.full(int(rec_len.sum()), ord("\n"), np.uint8)
    buf[np.repeat(rec_at - (np.cumsum(head_len) - head_len), head_len)
        + np.arange(head.shape[0])] = head
    j = np.arange(int(ln.sum())) - np.repeat(np.cumsum(ln) - ln, ln)
    buf[np.repeat(rec_at + head_len, ln) + j + j // 100] = _BASE_BYTES[
        pool[np.repeat(seq_off, ln) + j]]
    return buf


def edge_file_ids(edges):
    """Edge row -> 1-based .edge.gz file id (rep first, twin = id+1 —
    the reference loader's bal_edge convention, loadPreGraph.c:543).
    Returns (file_id (n_e,) int64, rep rows in file order (int64), next
    id).  The rule is sequential: in row order, a palindrome takes one
    id, a row no earlier rep named as its twin takes two (itself, then
    its twin).  Rows whose twins form an involution follow it by array
    operations; the rule itself runs, in row order, only where a twin is
    not an involution: on such a row, its twin and its twin's twin.  No
    other row names one of these as its twin, so the two sets keep to
    themselves."""
    n = edges.n_edges
    twin = _host(edges.twin[:n])
    row = np.arange(n)
    in_range = (twin >= 0) & (twin < n)
    pal = twin == row
    invol = in_range & (twin[np.where(in_range, twin, row)] == row)
    rep = invol & (row <= twin)
    odd = ~invol
    for _ in range(2):  # a non-involutive row's twin, then that twin's
        odd[twin[odd & in_range]] = True
    odd = np.flatnonzero(odd)
    claimed = np.zeros(n, bool)
    for e in odd.tolist():
        t = int(twin[e])
        rep[e] = t == e or not claimed[e]
        if rep[e] and t != e and 0 <= t < n:
            claimed[t] = True
    step = np.where(rep, np.where(pal, 1, 2), 0)
    first = np.cumsum(step) - step + 1
    file_id = np.zeros(n, np.int64)
    clean = rep.copy()
    clean[odd] = False
    file_id[clean] = first[clean]
    pair = clean & ~pal
    file_id[twin[pair]] = first[pair] + 1
    for e in odd[rep[odd]].tolist():
        t = int(twin[e])
        file_id[e] = first[e]
        if t != e and 0 <= t < n:
            file_id[t] = first[e] + 1
    return file_id, np.flatnonzero(rep), int(1 + step.sum())


def write_pregraph_files(prefix: str, table, edges, arcs, k: int) -> int:
    """Write .vertex, .edge.gz and .preArc; returns the vertex count
    (for .preGraphBasic's VERTEX field).  Each file is built as one
    uint8 buffer by whole-array operations (fields as byte columns, one
    boolean compaction; bases by a lookup, newlines by index arithmetic)
    and written in one call; .edge.gz is one gzip member at level 9, its
    text built a block of records at a time and deflated in chunks on
    every host core while the next block is built (``_GzipMember``; the
    same bytes whatever the core count).  Spans: the device-to-host
    copies ``pregraph.write.host``, then ``pregraph.write.vertex``,
    ``.edge`` and ``.arc``, one a file; inside ``.edge``,
    ``pregraph.write.edge.deflate`` times the main thread's part of the
    deflate: cutting chunks and the crc, inline deflates, waits on the
    pool's results and the file writes."""
    with profiling.span("pregraph.write.host"):
        keys = _host(table.keys)
        n_e = edges.n_edges
        from_node = _host(edges.from_node[:n_e])
        to_node = _host(edges.to_node[:n_e])
        length = _host(edges.length[:n_e])
        cvg = _host(edges.cvg[:n_e])
        twin = _host(edges.twin[:n_e])
        seq_off = _host(edges.seq_off[:n_e])
        pool = _host(edges.seq_pool)
        a_n = arcs.n
        f = _host(arcs.from_ed[:a_n])
        t = _host(arcs.to_ed[:a_n])
        m = _host(arcs.mult[:a_n])

    # vertex set: canonical rows of all live edge endpoints; 8 a line
    with profiling.span("pregraph.write.vertex"):
        rows = np.unique(np.concatenate([from_node, to_node]) >> 1)
        eighth = np.arange(1, len(rows) + 1) % 8 == 0
        text, _ = _records(_hex(keys[rows], k) + [
            _lit(b" ", len(rows)), _lit(b"\n", len(rows), eighth)])
        with open(prefix + ".vertex", "wb") as fh:
            fh.write(text.tobytes() + b"\n")

    # edges: rep first, twin implicit; built and deflated in blocks of
    # about _BLOCK_BASES bases, so the host's index arrays stay small
    with profiling.span("pregraph.write.edge"):
        file_id, order, _nxt = edge_file_ids(edges)
        n_r = len(order)
        ends = _oriented_lanes(torch.from_numpy(keys), torch.from_numpy(
            np.concatenate([from_node[order], to_node[order]])), k)
        ln = length[order]
        upto = np.cumsum(ln)
        cuts = np.unique(np.concatenate([[0], np.searchsorted(
            upto, np.arange(_BLOCK_BASES, upto[-1] if n_r else 0,
                            _BLOCK_BASES), side="right"), [n_r]]))
        with open(prefix + ".edge.gz", "wb") as fh, _GzipMember(fh) as gz:
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                rep, n = order[lo:hi], hi - lo
                text = _edge_text(
                    [_lit(b">length ", n)] + _dec(ln[lo:hi])
                    + [_lit(b",", n)] + _hex(ends[lo:hi], k)
                    + [_lit(b",", n)] + _hex(ends[n_r + lo:n_r + hi], k)
                    + [_lit(b",cvg ", n)] + _dec(cvg[rep])
                    + [_lit(b", ", n)] + _dec(twin[rep] != rep)
                    + [_lit(b"\n", n)], ln[lo:hi], seq_off[rep], pool)
                with profiling.span("pregraph.write.edge.deflate"):
                    gz.write(text)
            with profiling.span("pregraph.write.edge.deflate"):
                gz.close()

    # arcs: one line a from-edge, ascending; its to-edges in row order
    with profiling.span("pregraph.write.arc"):
        by_from = np.argsort(file_id[f], kind="stable")
        fe, te, mm = file_id[f][by_from], file_id[t][by_from], m[by_from]
        lead = np.ones(a_n, bool)
        lead[1:] = fe[1:] != fe[:-1]
        tail = np.ones(a_n, bool)
        tail[:-1] = lead[1:]
        text, _ = _records(
            _dec(fe, lead) + [_lit(b" ", a_n)] + _dec(te)
            + [_lit(b" ", a_n)] + _dec(mm) + [_lit(b"\n", a_n, tail)])
        with open(prefix + ".preArc", "wb") as fh:
            fh.write(text.tobytes())
    return len(rows)


def _parse_kmer_hex(words: List[str], k: int) -> List[int]:
    v = 0
    for t in words:
        v = (v << 64) | int(t, 16)
    return _int_to_lanes(v, bits.words_for_k(k))


def _row_keys(a: np.ndarray) -> np.ndarray:
    """(n, w) uint32 rows -> (n,) void keys that compare
    lexicographically (big-endian byte view) for sort/searchsorted."""
    if a.shape[0] == 0:
        return np.zeros(0, dtype=np.dtype((np.void, max(a.shape[1], 1) * 4)))
    be = np.ascontiguousarray(a.astype(">u4"))
    return be.view(np.dtype((np.void, a.shape[1] * 4))).reshape(-1)


def _canon_rows(rows: np.ndarray, k: int):
    """Canonical rows and the use-revcomp flags, on CPU tensors."""
    can, use_rc = bits.canonical(torch.from_numpy(rows.astype(np.int64)), k)
    return can.numpy().astype(np.uint32), use_rc.numpy()


def _kmer_codes(lanes: np.ndarray, k: int) -> np.ndarray:
    """(n, W) lanes -> (n, K) base codes, first base first."""
    w = lanes.shape[1]
    pos = 2 * (k - 1 - np.arange(k))
    return ((lanes[:, w - 1 - pos // 32].astype(np.int64) >> (pos % 32))
            & 3).astype(np.uint8)


def _read_pregraph_basic(prefix: str):
    k = None
    n_vt = 0
    with open(prefix + ".preGraphBasic") as fh:
        for line in fh:
            if line.startswith("VERTEX"):
                parts = line.split()
                n_vt, k = int(parts[1]), int(parts[3])
    if not k:
        raise ValueError(f"{prefix}.preGraphBasic has no VERTEX line")
    return n_vt, k


def _read_vertex_keys(prefix: str, n_vt: int, k: int) -> np.ndarray:
    """Sorted unique canonical vertex k-mers, (n, W) uint32."""
    w, nu = bits.words_for_k(k), _n_u64(k)
    toks: List[str] = []
    with open(prefix + ".vertex") as fh:
        for line in fh:
            toks.extend(line.split())
    raw = np.asarray([_parse_kmer_hex(toks[i * nu: (i + 1) * nu], k)
                      for i in range(n_vt)], np.uint32).reshape(n_vt, w)
    if not n_vt:
        return raw
    can = _canon_rows(raw, k)[0]
    can = can[np.argsort(_row_keys(can), kind="stable")]
    return np.unique(can, axis=0)  # defensive (twins listed)


def _read_edge_records(prefix: str, k: int):
    """(lengths, from lanes, to lanes, cvg, bal, sequences) per record."""
    lens, cvg, bal, seqs, fk, tk = [], [], [], [], [], []
    with gzip.open(prefix + ".edge.gz", "rt") as fh:
        parts: List[str] = []
        pending = False
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if pending:
                    seqs.append("".join(parts))
                    parts = []
                fields = line[len(">length "):].split(",")
                lens.append(int(fields[0]))
                fk.append(_parse_kmer_hex(fields[1].split(), k))
                tk.append(_parse_kmer_hex(fields[2].split(), k))
                cvg.append(int(fields[3].split()[1]))
                bal.append(int(fields[4].strip()))
                pending = True
            elif pending:
                parts.append("".join(c for c in line if c.isalpha()))
        if pending:
            seqs.append("".join(parts))
    w = bits.words_for_k(k)
    return (np.asarray(lens, np.int64),
            np.asarray(fk, np.uint32).reshape(-1, w),
            np.asarray(tk, np.uint32).reshape(-1, w),
            np.asarray(cvg, np.int64), np.asarray(bal, np.int64), seqs)


def _read_arcs(path: str):
    """(from, to, mult) of a .preArc or .Arc file ('from to1 m1 to2 m2
    ...' lines, 1-based ids), as 0-based int64 arrays."""
    fr, to, mu = [], [], []
    try:
        fh = open(path)
    except FileNotFoundError:
        fh = None
    if fh is not None:
        with fh:
            for line in fh:
                parts = line.split()
                if len(parts) < 3:
                    continue
                fe = int(parts[0]) - 1
                for i in range(1, len(parts) - 1, 2):
                    fr.append(fe)
                    to.append(int(parts[i]) - 1)
                    mu.append(int(parts[i + 1]))
    return (np.asarray(fr, np.int64), np.asarray(to, np.int64),
            np.asarray(mu, np.int64))


def load_pregraph_files(prefix: str, device):
    """Parse reference .preGraphBasic/.vertex/.edge.gz/.preArc into
    (vertex KmerTable, EdgeGraph, ArcSet, k) on ``device``, with the JAX
    loader's edge order: each record's row, then its twin's (explicit
    twin rows, like loadPreGraph.c's loadVertex/loadEdge/loadPreArcs).
    Sizes are exact; arc rows stay in file order."""
    from ..graph import arcs as arcs_mod
    from ..graph import unitigs

    n_vt, k = _read_pregraph_basic(prefix)
    w = bits.words_for_k(k)
    vt_keys = _read_vertex_keys(prefix, n_vt, k)
    vt_void = _row_keys(vt_keys)
    lens, fk, tk, cvg_r, bal, seqs = _read_edge_records(prefix, k)

    def vt_ids(raw):
        can, use_rc = _canon_rows(raw, k)
        idx = np.searchsorted(vt_void, _row_keys(can))
        idx = np.clip(idx, 0, max(vt_keys.shape[0] - 1, 0))
        if not vt_keys.shape[0] or not (vt_keys[idx] == can).all():
            raise ValueError(f"{prefix}.edge.gz names a k-mer that "
                             f"{prefix}.vertex lacks")
        return 2 * idx + use_rc.astype(np.int64)

    n_r = lens.shape[0]
    # record r occupies slots [slot[r], slot[r] + 1 + bal[r])
    per = 1 + bal
    slot = np.cumsum(per) - per
    n_e = int(per.sum())
    from_node = np.zeros(n_e, np.int64)
    to_node = np.zeros(n_e, np.int64)
    length = np.zeros(n_e, np.int64)
    cvg = np.zeros(n_e, np.int64)
    twin = np.zeros(n_e, np.int64)
    seq_off = np.zeros(n_e, np.int64)
    chunks: List[np.ndarray] = []
    if n_r:
        fk_id, tk_id = vt_ids(fk), vt_ids(tk)
        pair = bal == 1
        tw = slot[pair] + 1
        from_node[slot], to_node[slot] = fk_id, tk_id
        length[slot], cvg[slot] = lens, cvg_r
        twin[slot] = np.where(pair, slot + 1, slot)
        # twin record: vt_id(revcomp(x)) shares x's canonical row with
        # flipped orientation (odd K has no palindromic k-mers)
        from_node[tw], to_node[tw] = tk_id[pair] ^ 1, fk_id[pair] ^ 1
        length[tw], cvg[tw], twin[tw] = lens[pair], cvg_r[pair], slot[pair]

        # sequence pool: record seqs from text; a twin's seq is the
        # revcomp of (K-prefix + seq) minus its own K-prefix
        fk_codes = _kmer_codes(fk, k)
        off = 0
        for r in range(n_r):
            codes = bits._CHAR2CODE[np.frombuffer(seqs[r].encode(), np.uint8)]
            seq_off[slot[r]] = off
            chunks.append(codes)
            off += codes.shape[0]
            if pair[r]:
                rc = (np.concatenate([fk_codes[r], codes])[::-1] ^ 2)[k:]
                seq_off[slot[r] + 1] = off
                chunks.append(rc.astype(np.uint8))
                off += rc.shape[0]
    pool = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)

    def dev(a, fill=None, size=None):
        if fill is not None and a.shape[0] < size:
            a = np.concatenate([a, np.full(size - a.shape[0], fill, a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    e_cap = max(n_e, 1)
    n_v = vt_keys.shape[0]
    none = torch.full((2 * max(n_v, 1),), -1, dtype=torch.int64,
                      device=device)
    edges = unitigs.EdgeGraph(
        dev(from_node, -1, e_cap), dev(to_node, -1, e_cap),
        dev(length, 0, e_cap), dev(cvg, 0, e_cap), dev(twin, -1, e_cap),
        dev(seq_off, 0, e_cap), dev(pool, 0, max(pool.shape[0], 1)), n_e,
        none, none.clone(),
        torch.zeros(e_cap, dtype=torch.bool, device=device))

    cap_v = max(n_v, 1)
    keys = np.full((cap_v, w), dictionary.SENTINEL, np.int64)
    keys[:n_v] = vt_keys
    zeros = torch.zeros(cap_v, dtype=torch.int32, device=device)
    table = dictionary.KmerTable(
        dev(keys), zeros, zeros.new_zeros((cap_v, 4)),
        zeros.new_zeros((cap_v, 4)), n_v,
        torch.zeros(cap_v, dtype=torch.bool, device=device))

    fr, to, mu = _read_arcs(prefix + ".preArc")
    aset = arcs_mod.ArcSet(dev(fr), dev(to), dev(mu), int(fr.shape[0]))
    return table, edges, aset, k


def write_contig_graph_files(prefix: str, ctg, table, k: int,
                             perm: List[int]) -> None:
    """.updated.edge + .Arc in the .contig/.ContigIndex numbering
    (perm: new id - 1 -> contig row, from write_contig_fasta)."""
    n = ctg.n
    length = _host(ctg.length[:n])
    cvg = _host(ctg.cvg[:n])
    twin = _host(ctg.twin[:n])
    from_km = _oriented_lanes(table.keys, ctg.from_node[:n], k)
    to_km = _oriented_lanes(table.keys, ctg.to_node[:n], k)
    new_of = np.zeros(n, np.int64)
    new_of[np.asarray(perm, np.int64)] = np.arange(1, len(perm) + 1)

    out = [f"EDGEs {len(perm)}\n"]
    for row in perm:
        t = int(twin[row])
        if t == row:
            s = 0
        else:
            s = 1 if new_of[row] < new_of[t] else -1
        ln = int(length[row])
        full = ln + k if ln else 0
        out.append(f">length {full},{s},{int(cvg[row])} "
                   f"{_kmer_hex(from_km[row], k)},"
                   f"{_kmer_hex(to_km[row], k)},\n")
    with open(prefix + ".updated.edge", "w") as fh:
        fh.write("".join(out))

    arcs = ctg.arcs
    f = _host(arcs.from_ed[:arcs.n])
    t = _host(arcs.to_ed[:arcs.n])
    m = _host(arcs.mult[:arcs.n])
    by_from: dict = {}
    for i in np.flatnonzero((f >= 0) & (f < n) & (t >= 0) & (t < n)).tolist():
        by_from.setdefault(int(new_of[f[i]]), []).append(
            (int(new_of[t[i]]), int(m[i])))
    out = []
    for fe in sorted(by_from):
        out.append(str(fe))
        for j, (te, mm) in enumerate(by_from[fe]):
            out.append(f" {te} {mm}")
            if (j + 1) % 10 == 0:
                out.append(f"\n{fe}")
        out.append("\n")
    with open(prefix + ".Arc", "w") as fh:
        fh.write("".join(out))


_REVCOMP = str.maketrans("ACGT", "TGCA")


def _read_contig_fasta(path: str, n: int) -> List[str]:
    """Sequences of a .contig file by 0-based id ('' where absent)."""
    seqs = [""] * n
    try:
        fh = open(path)
    except FileNotFoundError:
        return seqs
    with fh:
        cur, buf = None, []
        for line in fh:
            if line.startswith(">"):
                if cur is not None:
                    seqs[cur] = "".join(buf)
                cur, buf = int(line.split()[0][1:]) - 1, []
            else:
                buf.append(line.strip())
        if cur is not None:
            seqs[cur] = "".join(buf)
    return seqs


def load_contig_graph_files(prefix: str, device):
    """Parse reference .preGraphBasic/.updated.edge/.Arc/.contig into
    (Contigs, KmerTable, k) on ``device``; row order = .updated.edge
    record order (file id - 1), the .ContigIndex numbering the map stage
    uses.  Each contig's first k-mer becomes a row of a small table that
    its from_node points at, with the right orientation.  Also writes
    .newContigIndex like the reference scaff loader (loadGraph.c:241-331).
    Sizes are exact; arc rows stay in file order."""
    from ..graph import arcs as arcs_mod
    from ..graph import contig_merge

    _n_vt, k = _read_pregraph_basic(prefix)
    lengths, bals, cvgs = [], [], []
    with open(prefix + ".updated.edge") as fh:
        for line in fh:
            if line.startswith(">"):
                f0, f1, rest = line[len(">length "):].split(",", 2)
                lengths.append(int(f0))
                bals.append(int(f1))
                cvgs.append(int(rest.split()[0]))
    n = len(lengths)
    length = np.asarray(lengths, np.int64)
    bal = np.asarray(bals, np.int64)
    twin = np.arange(n, dtype=np.int64) + np.where(np.abs(bal) == 1, bal, 0)

    # .newContigIndex: re-sort by full length asc, old index asc
    new_of = np.zeros(n, np.int64)
    new_of[np.argsort(length, kind="stable")] = np.arange(1, n + 1)
    with open(prefix + ".newContigIndex", "w") as fh:
        fh.write("".join(f"{old + 1} {new} {b + 1}\n" for old, (new, b)
                         in enumerate(zip(new_of.tolist(), bals))))

    # contig sequences (only reps are printed in .contig)
    seqs = _read_contig_fasta(prefix + ".contig", n)
    for i in range(n):
        if not seqs[i] and 0 <= twin[i] < n and seqs[twin[i]]:
            seqs[i] = seqs[twin[i]].translate(_REVCOMP)[::-1]

    tails = [s[k:] for s in seqs]
    tail_len = np.asarray([len(t) for t in tails], np.int64)
    seq_off = np.cumsum(tail_len) - tail_len
    pool = bits._CHAR2CODE[np.frombuffer("".join(tails).encode(), np.uint8)]

    w = bits.words_for_k(k)
    keys = np.full((max(n, 1), w), dictionary.SENTINEL, np.int64)
    from_node = np.full(n, -1, np.int64)
    code = {"A": 0, "C": 1, "T": 2, "G": 3}
    for i, s in enumerate(seqs):
        if len(s) < k:
            continue
        v = 0
        for ch in s[:k]:
            v = (v << 2) | code.get(ch, 0)
        can = min(v, _revcomp_int(v, k))
        keys[i] = _int_to_lanes(can, w)
        from_node[i] = 2 * i + (0 if v == can else 1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cap = max(n, 1)
    zeros = torch.zeros(cap, dtype=torch.int32, device=device)
    table = dictionary.KmerTable(
        dev(keys), zeros, zeros.new_zeros((cap, 4)),
        zeros.new_zeros((cap, 4)), n,
        torch.zeros(cap, dtype=torch.bool, device=device))

    fr, to, mu = _read_arcs(prefix + ".Arc")
    aset = arcs_mod.ArcSet(dev(fr), dev(to), dev(mu), int(fr.shape[0]))

    ctg = contig_merge.Contigs(
        dev(from_node), dev(np.full(n, -1, np.int64)),
        dev(np.maximum(length - k, 0)), dev(np.asarray(cvgs, np.int64)),
        dev(twin), dev(seq_off), dev(pool if pool.size else
                                     np.zeros(1, np.uint8)), n,
        dev(np.full(1, -1, np.int64)), aset)
    return ctg, table, k
