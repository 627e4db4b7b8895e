"""Stage-file writers (reference-compatible formats).

A jax-free copy of ``soapdenovo_trans_tpu/io/stagefiles.py``, which
imports the JAX package's ``ops/bits`` (and so ``jax``); the machine
that runs the port on the GPU has no jax.  The contig writers take the
port's tensors; the map and scaff writers take host arrays.  The
per-record Python loops of the JAX package's ``PathRecorder`` and of its
``-f`` writers are numpy here; the bytes are the same (the ``.gz``
files' after decompression).

``_write_columns`` is numpy-only (the JAX package writes through pandas
when it can import it; the GPU machine has no pandas) and gives the
bytes that pandas' ``to_csv`` gives for integer and string columns.  It
makes no Python string per field: a chunk of ``_ROWS_PER_CHUNK`` rows is
built as byte columns with the pregraph writer's helpers
(``graph_files._dec``, ``_lit``, ``_records``), the chunks on a pool of
one thread a host core (numpy frees the GIL over whole arrays), their
text written in chunk order.
"""

from __future__ import annotations

import gzip
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from ..ops import bits
from ..utils import profiling
from .graph_files import _deflate_workers, _dec, _lit, _records


def write_kmer_freq(path: str, histogram: np.ndarray) -> None:
    """.kmerFreq (reference freqStat, prlHashReads.c:994): one count
    per line for frequencies 1..255."""
    with open(path, "w") as fh:
        for i in range(1, len(histogram)):
            fh.write(f"{int(histogram[i])}\n")


def write_pregraph_basic(path: str, n_vertex: int, k: int, n_edge: int,
                         max_read_len: int, min_read_len: int = 0,
                         max_name_len: int = 256) -> None:
    """.preGraphBasic (reference output_vertex, output_pregraph.c:74)."""
    with open(path, "w") as fh:
        fh.write(f"VERTEX {n_vertex} K {k}\n")
        fh.write(f"\nEDGEs {n_edge}\n")
        fh.write(f"\nMaxReadLen {max_read_len} MinReadLen {min_read_len} "
                 f"MaxNameLen {max_name_len}\n")


def write_pe_grads(path: str, grads, n_reads: int,
                   max_read_len: int) -> None:
    """.peGrads (reference prlHashReads.c:635-644, parsed by
    loadPEgrads attachPEinfo.c:63): insert-size grads with cumulative
    read-count boundaries.  grads: [(insertS, pe_bound, rank,
    pair_num_cut)]."""
    with open(path, "w") as fh:
        fh.write(f"grads&num: {len(grads)}\t{n_reads}\t{max_read_len}\n")
        for ins, bound, rank, cut in grads:
            fh.write(f"{ins}\t{bound}\t{rank}\t{cut}\n")


def _wrap(seq: str, width: int = 100) -> str:
    return "\n".join(seq[i: i + width] for i in range(0, len(seq), width))


def write_contig_fasta(path: str, contigs, table, k: int,
                       arcs=None) -> List[int]:
    """.contig (reference output_contig, output_contig.c:120-240):
    contigs sorted by length ascending, ids assigned over the sorted
    order with twins sharing consecutive ids (only one of each twin
    pair printed), header '>id length L cvg_C.C_tip_T'.

    Returns the sorted-order permutation (new id - 1 -> contig row),
    the analogue of the reference's flag_array."""
    from ..graph import contig_merge

    n = contigs.n
    lengths = contigs.length[:n].cpu().numpy() + k
    twin = contigs.twin[:n].cpu().numpy()
    cvg = contigs.cvg[:n].cpu().numpy()
    seqs = contig_merge.contig_sequences(contigs, table, k)

    has_out = np.zeros(n, bool)
    if arcs is not None:
        f = arcs.from_ed[:arcs.n].cpu().numpy()
        has_out[f[(f >= 0) & (f < n)]] = True

    printed = np.zeros(n, bool)
    perm: List[int] = []
    out: List[str] = []
    cid = 0
    for row in np.argsort(lengths, kind="stable").tolist():
        if printed[row]:
            continue
        cid += 1
        perm.append(row)
        printed[row] = True
        t = int(twin[row])
        paired = 0 <= t < n
        if paired:
            printed[t] = True
        # a tip has arcs on at most one side (output_contig.c:232)
        tip = int(not (has_out[row] and paired and has_out[t]))
        out.append(f">{cid} length {lengths[row]} "
                   f"cvg_{cvg[row] / 10:.1f}_tip_{tip}\n")
        out.append(_wrap(seqs[row]) + "\n")
        if paired and t != row:
            cid += 1  # twin consumes an id, like the reference
            perm.append(t)
    with open(path, "w") as fh:
        fh.write("".join(out))
    return perm


def write_contig_index(path: str, contigs, k: int, perm) -> None:
    """.ContigIndex (reference output_contig.c:262-277)."""
    n = contigs.n
    lengths = contigs.length[:n].cpu().numpy() + k
    twin = contigs.twin[:n].cpu().numpy()
    out = [f"Edge_num {len(perm)} {len(perm)}\n",
           "index\tlength\treverseComplement\n"]
    i = 0
    while i < len(perm):
        row = perm[i]
        if twin[row] != row:
            out.append(f"{i + 1}\t{lengths[row]}\t1\n")
            i += 2
        else:
            out.append(f"{i + 1}\t{lengths[row]}\t0\n")
            i += 1
    with open(path, "w") as fh:
        fh.write("".join(out))


_ROWS_PER_CHUNK = 1 << 16


def _field(col) -> list:
    """The byte columns of one field: an integer column in decimal
    (``str(int)``), any other as ``str`` of each value (ASCII), read
    from the fixed-width code points of its ``numpy.str_`` view with
    the padding dropped."""
    col = np.asarray(col)
    if col.dtype.kind in "iu" and np.can_cast(col.dtype, np.int64):
        return _dec(col)
    codes = np.ascontiguousarray(col.astype(str)).view(np.uint32)
    codes = codes.reshape(col.shape[0], -1)
    return [(codes.astype(np.uint8), codes != 0)]


def _chunk_text(cols, lo: int, hi: int) -> np.ndarray:
    """Rows ``lo:hi`` as text: fields tab-separated, each row ended by a
    newline."""
    n = hi - lo
    parts = []
    for i, col in enumerate(cols):
        if i:
            parts.append(_lit(b"\t", n))
        parts += _field(col[lo:hi])
    parts.append(_lit(b"\n", n))
    return _records(parts)[0]


def _write_columns(path: str, header, cols, opener=open) -> None:
    """Tab-separated rows of equal-length 1-D columns behind an optional
    header line, written as bytes through ``opener``.  The rows are cut
    into chunks of ``_ROWS_PER_CHUNK``, each built by ``_chunk_text``;
    more than one chunk are built on a pool of up to one thread a host
    core and written in chunk order, one chunk or less on the calling
    thread.  Counters ``map.write.{rows,chunks}`` (added) and
    ``map.write.workers`` (the most threads one table used)."""
    n = len(cols[0])
    bounds = [(lo, min(lo + _ROWS_PER_CHUNK, n))
              for lo in range(0, n, _ROWS_PER_CHUNK)]
    workers = max(min(_deflate_workers(), len(bounds)), 1)
    with opener(path, "wb") as fh:
        if header is not None:
            fh.write((header + "\n").encode())
        if workers == 1:
            for lo, hi in bounds:
                fh.write(_chunk_text(cols, lo, hi))
        else:
            with ThreadPoolExecutor(workers) as pool:
                for text in pool.map(lambda b: _chunk_text(cols, *b),
                                     bounds):
                    fh.write(text)
    profiling.counter("map.write.rows", n)
    profiling.counter("map.write.chunks", len(bounds))
    profiling.counter_max("map.write.workers", workers)


def write_placement_table(path: str, readno, ctg, pos, orien) -> None:
    """.readOnContig / .ctg2Read (reference recordAlldgn,
    prlRead2Ctg.c:565-574): 'readno contig pos orien' rows behind a
    'read\\tcontig\\tpos' header (prlRead2Ctg.c:734,739).
    .ctg2Read's pos column is readOffset-contigOffset — the transcript
    stage's single-read linking input (singleRead2connection,
    transcriptome.c:256)."""
    _write_columns(path, "read\tcontig\tpos", (readno, ctg, pos, orien))


def write_read_information(path: str, readno, read_off, ctg, ctg_off,
                           align_len, orien) -> None:
    """.readInformation (reference prlRead2Ctg.c:575-588, -r/-R).
    No header — the reference's consumer sscanfs every line
    (getReadOnScaf, ReadTrace.c:69)."""
    _write_columns(path, None,
                   (readno, read_off, ctg, ctg_off, align_len, orien))


class PathRecorder:
    """repsTie outputs: binary `.path` (per recorded read, a 1-byte
    edge count + that many uint32 1-based edge file ids) and the
    `.markOnEdge` marker counts (saturating u8 per edge file id) —
    recordPathBin, reference prlRead2path.c:507-573.  A read is
    recorded when its leading unbroken edge path has >= 3 edges
    (the reference's mixBuffer[start..start+2] nonzero check).

    The reference v1.04 parses no flag that sets repsTie — its
    `case 'R'` is commented out (pregraph.c:149-151) — so these files
    are a documented superset behind -R, as in the JAX package."""

    MIN_PATH = 3
    MAX_IDS = 255  # a record's edge count is one byte

    def __init__(self, path: str, file_id: np.ndarray, n_file: int):
        self.fh = open(path, "wb")
        self.file_id = file_id  # edge row -> 1-based file id
        self.markers = np.zeros(n_file, np.int64)  # index = file id
        self.n_reads = 0

    def add_paths(self, lengths: np.ndarray, edges: np.ndarray) -> None:
        """The leading paths of a read batch, in read order (what
        ``graph/arcs.leading_paths`` returns): ``lengths`` (n,) edges
        per recorded read, each >= MIN_PATH; ``edges`` (sum,) their edge
        rows, read-major."""
        ids = self.file_id[edges]
        self.markers += np.bincount(ids, minlength=self.markers.shape[0])
        kept = np.minimum(lengths, self.MAX_IDS)
        rec_off = np.cumsum(1 + 4 * kept) - (1 + 4 * kept)
        out = np.zeros(int((1 + 4 * kept).sum()), np.uint8)
        out[rec_off] = kept
        within = np.arange(ids.shape[0]) - np.repeat(
            np.cumsum(lengths) - lengths, lengths)
        keep = within < self.MAX_IDS
        pos = np.repeat(rec_off + 1, lengths)[keep] + 4 * within[keep]
        out[pos[:, None] + np.arange(4)] = \
            ids[keep].astype("<u4").view(np.uint8).reshape(-1, 4)
        self.fh.write(out.tobytes())
        self.n_reads += int(lengths.shape[0])

    def close(self) -> np.ndarray:
        self.fh.close()
        print(f"[pregraph] {int(self.markers.sum())} markers counted "
              f"({self.n_reads} read paths)")
        return np.minimum(self.markers, 255)


def read_path_bin(path: str):
    """Parse a binary `.path` file back into per-read 1-based edge
    file-id arrays (inverse of PathRecorder; record layout matches the
    reference's recordPathBin, prlRead2path.c:507-573)."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        n = data[pos]
        pos += 1
        out.append(np.frombuffer(data, "<u4", count=n, offset=pos)
                   .astype(np.int64))
        pos += 4 * n
    return out


def write_mark_on_edge(path: str, markers: np.ndarray,
                       n_edges_file: int) -> None:
    """.markOnEdge: one saturating count per edge file id 1..num_ed
    (reference prlRead2path.c:464-471)."""
    m = np.zeros(n_edges_file + 1, np.int64)
    n = min(m.shape[0], markers.shape[0])
    m[:n] = np.minimum(markers[:n], 255)
    with open(path, "w") as fh:
        fh.write("".join(f"{x}\n" for x in m[1:].tolist()))


class GapReads:
    """The -f payload of the map stage: the reads dropped into gaps, in
    file order.  ``codes`` is a (n, L) uint8 matrix of base codes, of
    which row i holds ``lens[i]``."""

    def __init__(self, readno, ctg0, pos, codes, lens):
        self.readno = np.asarray(readno, np.int64)  # 1-based read number
        self.ctg0 = np.asarray(ctg0, np.int64)      # 0-based contig row
        self.pos = np.asarray(pos, np.int64)        # projected position
        self.codes = np.asarray(codes, np.uint8)
        self.lens = np.asarray(lens, np.int64)

    def __len__(self) -> int:
        return self.readno.shape[0]

    @classmethod
    def concat(cls, parts, width: int) -> "GapReads":
        """Several GapReads in order; ``width`` is L of the result."""
        def col(name):
            vals = [getattr(p, name) for p in parts]
            return np.concatenate(vals) if vals else np.zeros(0)
        codes = np.full((sum(len(p) for p in parts), width), bits.BASE_N,
                        np.uint8)
        lo = 0
        for p in parts:
            codes[lo:lo + len(p), :p.codes.shape[1]] = p.codes
            lo += len(p)
        return cls(col("readno"), col("ctg0"), col("pos"), codes, col("lens"))


def write_read_in_gap(path: str, reads: GapReads) -> None:
    """.readInGap in the reference's BINARY format (output1read,
    prlRead2Ctg.c:422-446; consumed by loadReads4gap/getRead1by1,
    prlReadFillGap.c:158-197): per record int32 len, int32 contig id
    (1-based), int32 projected pos, then len//4+1 tightString bytes
    (2 bits/base, big-endian within each byte — seq.c:49-72)."""
    n, width = reads.codes.shape
    quads = -(-width // 4) + 1  # bytes of the longest record, and one
    live = np.arange(width)[None, :] < reads.lens[:, None]
    two_bit = np.zeros((n, 4 * quads), np.uint8)
    two_bit[:, :width] = np.where(live, reads.codes & 3, 0)
    two_bit = two_bit.reshape(n, quads, 4)
    packed = (two_bit[:, :, 0] << 6) | (two_bit[:, :, 1] << 4) | \
        (two_bit[:, :, 2] << 2) | two_bit[:, :, 3]
    head = np.stack([reads.lens, reads.ctg0 + 1, reads.pos],
                    1).astype("<i4").view(np.uint8).reshape(n, 12)
    used = np.arange(quads)[None, :] < (reads.lens // 4 + 1)[:, None]
    record = np.concatenate([head, packed], 1)
    mask = np.concatenate([np.ones((n, 12), bool), used], 1)
    with open(path, "wb") as fh:
        fh.write(record[mask].tobytes())


def write_pe_read_on_contig(path: str, rows: np.ndarray) -> None:
    """.PEreadOnContig.gz (reference getPEreadOnContig, -f flag):
    pairs with both ends mapped — 'readno ctg1 pos1 ctg2 pos2'."""
    _write_columns(path, None, tuple(rows.T) if rows.shape[0] else ((),),
                   opener=gzip.open)


def write_short_read_in_gap(path: str, reads: GapReads) -> None:
    """.shortreadInGap.gz (reference output1read, -f flag): the
    sequences of gap-related reads for external gap fillers (SRkgf)."""
    lut = np.frombuffer(b"ACTGN", np.uint8)
    text = lut[np.minimum(reads.codes, bits.BASE_N)]
    with gzip.open(path, "wt") as fh:
        fh.write("".join(
            f">read_{rn}\n{text[i, :ln].tobytes().decode()}\n"
            for i, (rn, ln) in enumerate(zip(reads.readno.tolist(),
                                             reads.lens.tolist()))))


def read_scaf_gap(path: str, ctg_len_excl, k: int):
    """Rebuild the transcript list from a .scaf_gap file (-S resume,
    reference prlReadFillGap.c:1227 reparses .scaf_gap the same way).
    Coordinates are in K-exclusive contig-length space and contig ids
    are 1-based directed ids (outputOneTranscriptome,
    transcriptome.c:1158-1219), so reference-written files load too.
    GAP route lines are skipped (routes are re-derived when needed).
    Returns a list of stages.scaff.Transcript."""
    from ..stages.scaff import Transcript

    transcripts = []

    def flush():
        if meta is not None:
            # physical gap = coordinate gap (K-exclusive space) - K
            gaps = [positions[i + 1] - (positions[i] + int(ctg_len_excl[c]))
                    - k for i, c in enumerate(contigs[:-1])]
            transcripts.append(Transcript(*meta, contigs, gaps))

    contigs: List[int] = []
    positions: List[int] = []
    meta = None
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if not line or line.startswith("GAP"):
                continue
            if line[0] == ">":
                flush()
                parts = line[1:].split()
                _, lid, lidx = parts[3].split("_")  # Locus_<id>_<n>
                meta = (int(lid), int(lidx), parts[4])
                contigs, positions = [], []
            else:
                c, pos = line.split()[:2]
                contigs.append(int(c) - 1)
                positions.append(int(pos))
    flush()
    return transcripts


def write_gap_seq(path: str, gap_report) -> None:
    """.gapSeq (reference outputSeqs/searchFgap, prlReadFillGap.c:1174,
    localAsm.c:739): one record per closed gap —
    '>scaffoldN_J method' + the sequence placed in the gap (empty for
    pure overlap merges)."""
    with open(path, "w") as fh:
        for scaf_idx, junc_idx, method, seq in gap_report:
            fh.write(f">scaffold{scaf_idx}_{junc_idx} {method}\n")
            if seq:
                fh.write(seq + "\n")


def write_scaf_files(prefix: str, transcripts, recs, ctg_len_excl,
                     twin, k: int, placements=None, routes=None,
                     n_runs=None) -> None:
    """.scaf / .scaf_gap / .contigPosInscaff / .agp in the reference
    formats (outputOneTranscriptome transcriptome.c:1158-1219,
    outputScafSeq prlReadFillGap.c:597-700).

    * .scaf / .scaf_gap coordinates are K-exclusive cumulative contig
      starts (start += length + gap); ids are 1-based, twin-resolved
      (smaller id + strand) in .scaf, raw directed in .scaf_gap.
    * GAP lines carry unique arc routes: 'GAP <route len> <seg> <ids>'
      (output1gap, orderContig.c:2313-2343).
    * .contigPosInscaff / .agp use RENDERED sequence coordinates from
      `placements` ([(ctg, out_start, out_len, strand)] per record).
    """
    routes = routes or {}
    n_runs = n_runs or {}
    scaf = open(prefix + ".scaf", "w")
    scaf_gap = open(prefix + ".scaf_gap", "w")
    cpis = open(prefix + ".contigPosInscaff", "w")
    agp = open(prefix + ".agp", "w")
    jid = 0
    for idx, tr in enumerate(transcripts, start=1):
        total = 0
        for i, c in enumerate(tr.contigs):
            total += int(ctg_len_excl[c])
            if i < len(tr.gaps):
                total += tr.gaps[i] + k  # CONNECT gap (K-exclusive)
        head = (f">scaffold{idx} {len(tr.contigs)} {total} "
                f"Locus_{tr.locus}_{tr.index} {tr.kind}\n")
        scaf.write(head)
        scaf_gap.write(head)
        pos = 0
        for i, c in enumerate(tr.contigs):
            fwd = c <= int(twin[c])
            rep = (c if fwd else int(twin[c])) + 1
            ln = int(ctg_len_excl[c])
            scaf.write(f"{rep:<10d} {pos:<10d} {'+' if fwd else '-'}   "
                       f"{ln + k} \n")
            if i > 0 and (jid + i - 1) in routes:
                r = routes[jid + i - 1]
                rlen = sum(int(ctg_len_excl[x]) for x in r)
                scaf_gap.write(
                    f"GAP {rlen} {len(r)}"
                    + "".join(f" {x + 1}" for x in r) + "\n")
            scaf_gap.write(f"{c + 1:<10d} {pos:<10d}\n")
            if i < len(tr.gaps):
                pos += ln + tr.gaps[i] + k
        jid += max(len(tr.contigs) - 1, 0)
        # .contigPosInscaff / .agp from rendered placements
        if placements is None or idx - 1 >= len(placements):
            continue
        cpis.write(f">scaffold{idx} Locus_{tr.locus}_{tr.index}\n")
        part = 0
        prev_end = 0
        for (c, start, out_len, strand) in placements[idx - 1]:
            rep = (c if strand == "+" else int(twin[c])) + 1
            full = int(ctg_len_excl[c]) + k
            if start > prev_end:  # N run before this contig
                part += 1
                agp.write(f"scaffold{idx}\t{prev_end + 1}\t{start}\t"
                          f"{part}\tN\t{start - prev_end}\tfragment\t"
                          f"yes\n")
            cpis.write(f"{rep}\t{start}\t{strand}\t{out_len}\n")
            part += 1
            agp.write(f"scaffold{idx}\t{start + 1}\t{start + out_len}\t"
                      f"{part}\tW\t{rep}\t{full - out_len + 1}\t{full}\t"
                      f"{strand}\n")
            prev_end = start + out_len
    for fh in (scaf, scaf_gap, cpis, agp):
        fh.close()


def _stat_section(fo, title, recs, len_cut=100, known_genome_size=0,
                  scaffold_word="scaffolds", count_key="Scaffold_Num",
                  singletons=False, n_break=False,
                  diff_word="scaffold"):
    """One section of the .scafStatistics report (ScafStat,
    reference src/orderContig.c:2421-3090): composition, size ladder,
    N10..N90 with counts, NG50.  recs: [(header, seq)]; records
    shorter than len_cut are excluded entirely (:2503-2519)."""
    fo.write(title + "\n\n")
    kept = [(h, s) for h, s in recs if len(s) >= len_cut]
    if not kept:
        fo.write("Size_includeN\t0\n\n")
        return 0, 0
    comp = {c: 0 for c in "ACGTN"}
    non_acgtn = 0
    sizes = []
    n_singleton = 0
    for h, s in kept:
        sizes.append(len(s))
        if h.startswith("C"):
            n_singleton += 1
        up = s.upper()
        for c in "ACGTN":
            comp[c] += up.count(c)
        non_acgtn += len(s) - sum(up.count(c) for c in "ACGTN")
    sizes.sort()  # ascending, like the reference qsort (:2620)
    n = len(sizes)
    total = sum(sizes)
    fo.write(f"Size_includeN\t{total}\n")
    fo.write(f"Size_withoutN\t{total - comp['N']}\n")
    fo.write(f"{count_key}\t{n}\n")
    fo.write(f"Mean_Size\t{total // n}\n")
    fo.write(f"Median_Size\t{sizes[(n + 1) // 2 - 1]}\n")
    fo.write(f"Longest_Seq\t{sizes[-1]}\n")
    fo.write(f"Shortest_Seq\t{sizes[0]}\n")
    if singletons:
        fo.write(f"Singleton_Num\t{n_singleton}\n")
        fo.write("Average_length_of_break(N)_in_scaffold\t"
                 f"{comp['N'] // n}\n")
        fo.write("\n")
        if known_genome_size:
            fo.write(f"Known_genome_size\t{known_genome_size}\n")
            fo.write("Total_scaffold_length_as_percentage_of_known_"
                     f"genome_size\t{100.0 * total / known_genome_size:.2f}%\n")
        else:
            fo.write("Known_genome_size\tNaN\n")
            fo.write("Total_scaffold_length_as_percentage_of_known_"
                     "genome_size\tNaN\n")
    fo.write("\n")
    for label, cut in ((">100 ", 100), (">500 ", 500), (">1K  ", 1000),
                       (">10K ", 10000), (">100K", 100000),
                       (">1M  ", 1000000)):
        cnt = sum(1 for x in sizes if x > cut)
        fo.write(f"{scaffold_word}{label}\t{cnt}\t{100.0 * cnt / n:.2f}%\n")
    fo.write("\n")
    for c in "ACGT":
        fo.write(f"Nucleotide_{c}\t{comp[c]}\t"
                 f"{100.0 * comp[c] / total:.2f}%\n")
    fo.write(f"GapContent_N\t{comp['N']}\t"
             f"{100.0 * comp['N'] / total:.2f}%\n")
    fo.write(f"Non_ACGTN\t{non_acgtn}\t{100.0 * non_acgtn / total:.2f}%\n")
    acgt = sum(comp[c] for c in "ACGT")
    gc = 100.0 * (comp['G'] + comp['C']) / acgt if acgt else 0.0
    fo.write(f"GC_Content\t{gc:.2f}%\t\t(G+C)/(A+C+G+T)\n")
    fo.write("\n")
    # NXX ladder — exact emulation of the descending else-if chain
    # (:2695-2725): a single record crossing several decade boundaries
    # leaves the skipped decades unprinted, matching the reference.
    flags = [False] * 10
    n50 = 0
    ng50 = num_ng50 = 0
    flag_known = False
    acc = 0
    for i in range(n - 1, -1, -1):
        acc += sizes[i]
        rank = n - i
        for d in range(1, 9):
            lo, hi = total * d / 10.0, total * (d + 1) / 10.0
            if lo <= acc < hi and not flags[d]:
                fo.write(f"N{d}0\t{sizes[i]}\t{rank}\n")
                flags[d] = True
                if d == 5:
                    n50 = sizes[i]
                break
        else:
            if acc >= total * 0.9 and not flags[9]:
                fo.write(f"N90\t{sizes[i]}\t{rank}\n")
                flags[9] = True
        if known_genome_size and not flag_known and \
                acc >= known_genome_size * 0.5:
            ng50, num_ng50 = sizes[i], rank
            flag_known = True
    if not flags[5]:  # fallback N50 recomputation (:2727-2740)
        acc = 0
        for i in range(n - 1, -1, -1):
            acc += sizes[i]
            if acc >= total * 0.5:
                fo.write(f"N50\t{sizes[i]}\t{n - i}\n")
                n50 = sizes[i]
                break
    fo.write("\n")
    w = diff_word
    if known_genome_size:
        fo.write(f"NG50\t{ng50}\t{num_ng50}\n")
        fo.write(f"N50_{w}-NG50_{w}_length_difference\t"
                 f"{abs(n50 - ng50)}\n")
    else:
        fo.write("NG50\tNaN\tNaN\n")
        fo.write(f"N50_{w}-NG50_{w}_length_difference\tNaN\n")
    fo.write("\n")
    return n, n_singleton


def write_scaf_statistics(prefix: str, known_genome_size: int = 0,
                          len_cut: int = 100) -> None:
    """.scafStatistics — the two-section assembly report of ScafStat
    (reference src/orderContig.c:2421, called ScafStat(100, ...) from
    scaffold.c:68): scaffold stats from .scafSeq, contig stats from
    .contig, each with composition/size-ladder/N10..N90/NG50."""
    def _recs(path):
        out, head, seq = [], None, []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line[0] == ">":
                    if head is not None:
                        out.append((head, "".join(seq)))
                    head, seq = line[1:], []
                else:
                    seq.append(line)
        if head is not None:
            out.append((head, "".join(seq)))
        return out

    scaf_recs = _recs(prefix + ".scafSeq")
    ctg_recs = _recs(prefix + ".contig")
    with open(prefix + ".scafStatistics", "w") as fo:
        n_scaf, n_single = _stat_section(
            fo, f"<-- Information for assembly Scaffold "
                f"'{prefix}.scafSeq'.(cut_off_length < {len_cut}bp) -->",
            scaf_recs, len_cut, known_genome_size,
            scaffold_word="scaffolds", count_key="Scaffold_Num",
            singletons=True)
        n_ctg, _ = _stat_section(
            fo, f"<-- Information for assembly Contig "
                f"'{prefix}.contig'.(cut_off_length < {len_cut}bp) -->",
            ctg_recs, len_cut, known_genome_size,
            scaffold_word="Contig", count_key="Contig_Num",
            diff_word="contig")
        # closing summary (ScafStat tail, orderContig.c:3079-3085):
        # singleton count from the SCAFFOLD section, contig count from
        # the contig section, average contigs per scaffold record
        fo.write("Number_of_contigs_in_scaffolds(Singleton)\t"
                 f"{n_single}\n")
        fo.write(f"Number_of_contigs_not_in_scaffolds\t"
                 f"{n_ctg - n_single}\n")
        avg = 1.0 * n_ctg / n_scaf if n_scaf else 0.0
        fo.write(f"Average_number_of_contigs_per_scaffold\t{avg:.1f}\n")
        fo.write("\n")


def write_read_on_scaf(prefix: str, k: int, full_len, twin) -> None:
    """.readOnScaf (reference getReadOnScaf, ReadTrace.c:41-160): join
    .readInformation (read->contig alignments, map -r) with
    .contigPosInscaff (contig->scaffold placements) into per-scaffold
    read rows 'readID read_pos scafPos orient alignLength', then
    append unplaced contigs >= 100bp as '>C<id>' singleton sections.

    Faithful details: the first contig of a scaffold keeps raw
    coordinates, later contigs subtract the K overlap (and trim
    alignLength when the read starts inside the overlap); per-contig
    rows emit in reverse file order (the reference builds a prepend
    linked list and walks it); both twins are flagged placed.
    """
    full_len = np.asarray(full_len)
    twin = np.asarray(twin)

    by_ctg: dict = {}
    with open(prefix + ".readInformation") as fh:
        for line in fh:
            p = line.split()
            if len(p) < 6:
                continue
            by_ctg.setdefault(int(p[2]), []).append(
                (p[0], int(p[1]), int(p[3]), int(p[4]), p[5]))

    placed = set()
    out: List[str] = []
    with open(prefix + ".contigPosInscaff") as fh:
        is_first = False
        for line in fh:
            if line.startswith(">"):
                out.append(line)
                is_first = True
                continue
            p = line.split()
            if not p:
                continue
            cid, cstart, orient = int(p[0]), int(p[1]), p[2]
            placed.add(cid)
            placed.add(int(twin[cid - 1]) + 1)
            for rid, rpos, cpos, alen, ro in reversed(by_ctg.get(cid, [])):
                if is_first:
                    spos, salen = cstart + cpos, alen
                else:
                    spos = cstart + cpos - k
                    salen = alen - k + cpos if cpos < k else alen
                so = "+" if ro == orient else "-"
                out.append(f"{rid}\t{rpos}\t{spos}\t{so}\t{salen}\n")
            is_first = False

    # singleton sections: big unplaced contigs, ascending id
    for cid in range(1, full_len.shape[0] + 1):
        if int(full_len[cid - 1]) < 100 or cid in placed:
            continue
        out.append(f">C{cid}\n")
        placed.add(cid)
        placed.add(int(twin[cid - 1]) + 1)
        for rid, rpos, cpos, alen, ro in reversed(by_ctg.get(cid, [])):
            out.append(f"{rid}\t{rpos}\t{cpos}\t{ro}\t{alen}\n")
    with open(prefix + ".readOnScaf", "w") as fh:
        fh.write("".join(out))
