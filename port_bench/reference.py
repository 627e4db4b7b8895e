"""The plain reference that decides ``correct``.

It works out, from the reads alone, what an assembly of them must
satisfy, and judges the stage files of an assembly by it.  It imports
neither the assembler nor JAX: plain PyTorch (on the card when there is
one, in blocks) and the stage files' published text formats
(SOAPdenovo-Trans v1.04: ``.kmerFreq``, ``.edge.gz``, ``.preArc``,
``.contig``, ``.ContigIndex``, ``.readOnContig``, ``.scafSeq``).

The numbers compared, one a layer of the pipeline, each an exact count
whose limit is 0:

* ``kmerfreq_bins_off``: bins of ``.kmerFreq`` (frequencies 1..255,
  the last holding every count >= 255) that differ from the histogram
  of the reads' canonical K-mer counts (counting);
* ``edge_kmers_unread``: K-mers of the ``.edge.gz`` edges (the from
  K-mer, then the bases the record appends) that occur in no read
  (pregraph: condensation);
* ``edge_kmers_shared``: canonical K-mers inside (neither end of) more
  than one edge record (pregraph: condensation);
* ``arcs_unjoined``: ``.preArc`` arcs whose to-edge does not start with
  the K-mer that ends their from-edge, or that name no edge (pregraph:
  threading);
* ``contig_kmers_unread``: K-mers of ``.contig`` that occur in no read
  (contig, after Tour-Bus);
* ``placements_off``: ``.readOnContig`` rows whose read, in the stated
  orientation and at the stated position, shares no K-mer with the
  contig (map);
* ``arcs_missing``: junctions of two edges through a vertex K-mer
  (each with an inner K-mer beside the vertex) that some read walks
  through, as the (K+2)-mer of the two inner K-mers and the vertex, and
  that ``.preArc`` lacks (pregraph: threading);
* ``transcript_pieces_off``: pieces of ``.scafSeq`` records that are not
  their contig's bases as ``.contigPosInscaff`` places them, scaffold
  records with bases outside every piece, and singleton records that
  are not their contig (scaff; a singleton ``C<n>`` is contig id
  n + 1).

Those find wrong output; these find output left out, each a count
whose limit ``LIMITS`` sets from the program's readings and the
controls':

* ``edge_kmers_missing_pct``: the share, in percent, of the K-mers read
  at least ``SOLID`` times that lie in no ``.edge.gz`` edge (pregraph:
  its cleaning drops a few, the minor branches beside a deep
  transcript, so the limit is a share, the same at every size);
* ``contig_kmers_missing_pct``: the same share for the contigs
  (contig: its cleaning drops a few more);
* ``reads_unplaced``: reads that the map step's rule places and that
  ``.readOnContig`` lacks: at least max(5, min(read length, map_len) -
  K + 1) of the read's windows hit one contig, counting only K-mers
  that occur once among the contigs of >= K + 2 bp (map);
* ``contigs_unscaffolded``: contigs of >= ``SINGLETON_MIN`` bp that
  no ``.scafSeq`` piece holds, neither they nor their twins (scaff).

Bases are coded A0 C1 G2 T3 here (4 for N or a window that crosses the
end of a record); the stage files' K-mer words use SOAPdenovo's A0 C1
T2 G3, which ``_WORD_CODE`` translates.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Tuple

import numpy as np
import torch

MAX_FREQ = 256  # .kmerFreq holds frequencies 1..MAX_FREQ - 1
SOLID = 8  # reads of a K-mer that no cleaning step of the cells removes
MAP_LEN = 32  # the [LIB] map_len default of SOAPdenovo-Trans v1.04
SINGLETON_MIN = 100  # scaff writes every leftover contig of this size
# the numbers that find wrong output are exact counts of violations,
# limit 0; those that find output left out have limits set from the
# program's readings and the controls' (PERF.md, section 2)
LIMITS = {**{name: 0 for name in (
    "kmerfreq_bins_off", "edge_kmers_unread", "edge_kmers_shared",
    "arcs_unjoined", "arcs_missing", "contig_kmers_unread",
    "placements_off", "transcript_pieces_off", "reads_unplaced",
    "contigs_unscaffolded")},
    "edge_kmers_missing_pct": 0.5, "contig_kmers_missing_pct": 1.0}
_MIX = (-7046029254386353131, -4658895280553007687)  # odd, for pair keys
_CHAR_CODE = np.full(256, 4, np.int8)
for _i, _c in enumerate(b"ACGT"):
    _CHAR_CODE[_c] = _i
    _CHAR_CODE[ord(chr(_c).lower())] = _i
_WORD_CODE = np.array([0, 1, 3, 2], np.int8)  # A0 C1 T2 G3 -> A0 C1 G2 T3


# ---- K-mers -------------------------------------------------------------

def kmer_values(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Canonical values of every window of ``k`` bases of a 1-D code
    tensor (int64, codes 0-3, 4 invalid), and whether the window holds
    only bases.  Returns ((N - k + 1,) int64, (N - k + 1,) bool)."""
    fw, rc, ok = strand_values(codes, k)
    return torch.minimum(fw, rc), ok


def strand_values(codes: torch.Tensor, k: int):
    """Each window's value, its reverse complement's, and whether it
    holds only bases."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        e = codes.new_zeros(0)
        return e, e, e.bool()
    fw = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    bad = torch.zeros(n, dtype=torch.bool, device=codes.device)
    for j in range(k):
        b = codes[j:j + n]
        bad |= b > 3
        b = b.clamp(max=3)
        fw = (fw << 2) | b
        rc = rc | ((3 - b) << (2 * j))
    return fw, rc, ~bad


def pair_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """A strand-free 64-bit key of every window of k + 2 bases (from its
    first and last K-mer; -1 where it holds a non-base).  Distinct
    windows collide with odds of about n^2 / 2^64."""
    fw, rc, ok = strand_values(codes, k)
    if fw.shape[0] < 3:
        return fw.new_zeros(0)
    a, b = fw[:-2], fw[2:]
    key = torch.minimum(a * _MIX[0] + b * _MIX[1],
                        rc[2:] * _MIX[0] + rc[:-2] * _MIX[1])
    return torch.where(ok[:-2] & ok[2:], key, -1)


def _joined_codes(seqs: List[bytes], device) -> torch.Tensor:
    """Byte sequences as one code tensor, an N between records."""
    return torch.from_numpy(_CHAR_CODE[np.frombuffer(
        b"N".join(seqs), np.uint8)].astype(np.int64)).to(device)


def _read_block(reads: np.ndarray, lo: int, n: int,
                device) -> torch.Tensor:
    """Reads lo..lo + n as one code tensor, an N after each read."""
    blk = torch.from_numpy(reads[lo:lo + n].astype(np.int64)).to(device)
    return torch.cat([blk, blk.new_full((blk.shape[0], 1), 4)], 1)


def _records_kmers(seqs: List[bytes], k: int, device) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Canonical K-mers of byte sequences, concatenated with an N
    between records.  Returns (values, valid, record of each window)."""
    if not seqs:
        e = torch.zeros(0, dtype=torch.int64, device=device)
        return e, e.bool(), e
    vals, ok = kmer_values(_joined_codes(seqs, device), k)
    lens = np.array([len(s) + 1 for s in seqs], np.int64)
    rec = np.repeat(np.arange(len(seqs)), lens)[:vals.shape[0]]
    return vals, ok, torch.from_numpy(rec).to(device)


class ReadKmers:
    """The reads' canonical K-mers, sorted and unique, with counts."""

    def __init__(self, reads: np.ndarray, k: int, device,
                 block_rows: int = 1 << 18):
        parts, counts = [], []
        for lo in range(0, reads.shape[0], block_rows):
            blk = _read_block(reads, lo, block_rows, device)
            vals, ok = kmer_values(blk.reshape(-1), k)
            u, c = torch.unique(vals[ok], return_counts=True)
            parts.append(u)
            counts.append(c)
        vals = torch.cat(parts)
        cnt = torch.cat(counts)
        self.keys, inv = torch.unique(vals, return_inverse=True)
        self.count = torch.zeros_like(self.keys).index_add_(0, inv, cnt)

    def contains(self, q: torch.Tensor) -> torch.Tensor:
        if self.keys.numel() == 0:
            return torch.zeros_like(q, dtype=torch.bool)
        i = torch.searchsorted(self.keys, q).clamp(
            max=self.keys.shape[0] - 1)
        return self.keys[i] == q

    def histogram(self) -> np.ndarray:
        """Counts of K-mers by frequency 1..MAX_FREQ - 1, the last bin
        holding every higher count."""
        c = self.count.clamp(max=MAX_FREQ - 1)
        h = torch.bincount(c, minlength=MAX_FREQ).cpu().numpy()
        return h[1:MAX_FREQ]


# ---- stage files --------------------------------------------------------

def read_fasta(path: str, opener=open) -> List[Tuple[str, bytes]]:
    """(header, bases) of each record of a FASTA file."""
    with opener(path, "rb") as fh:
        data = fh.read()
    out = []
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        out.append((head.decode(), body.replace(b"\n", b"")))
    return out


def _word_bases(words: List[str], k: int) -> List[bytes]:
    """K-mers of a stage file (hex words, SOAPdenovo's base code, first
    base in the highest bits) as bases."""
    vals = [0] * len(words)
    for i, w in enumerate(words):
        for part in w.split():
            vals[i] = (vals[i] << 64) | int(part, 16)
    out = []
    for lo in range(0, len(vals), 1 << 16):
        chunk = vals[lo:lo + (1 << 16)]
        codes = np.zeros((len(chunk), k), np.int64)
        for j in range(k):  # k passes over the chunk, not one a K-mer
            shift = 2 * (k - 1 - j)
            codes[:, j] = [(v >> shift) & 3 for v in chunk]
        text = np.frombuffer(b"ACGT", np.uint8)[_WORD_CODE[codes]]
        out.extend(bytes(r) for r in text)
    return out


def read_edges(path: str, k: int) -> Tuple[Dict[int, bytes], List[int]]:
    """Edge id -> full sequence: each ``.edge.gz`` record (the from
    K-mer, then the bases it appends) at its file id, and for a record
    with bal 1 its twin, the reverse complement, at the next id; and
    the records' ids."""
    recs = read_fasta(path, gzip.open)
    fields = [h.split(",") for h, _ in recs]
    firsts = _word_bases([f[1] for f in fields], k)
    edges: Dict[int, bytes] = {}
    ids = []
    nxt = 1
    for f, first, (_, body) in zip(fields, firsts, recs):
        edges[nxt] = first + body
        ids.append(nxt)
        if int(f[-1].strip()):
            edges[nxt + 1] = revcomp(edges[nxt])
            nxt += 1
        nxt += 1
    return edges, ids


def read_arcs(path: str) -> np.ndarray:
    """(A, 3) int64 rows (from id, to id, multiplicity) of ``.preArc``."""
    rows = []
    with open(path) as fh:
        for line in fh:
            v = [int(x) for x in line.split()]
            for i in range(1, len(v), 2):
                rows.append((v[0], v[i], v[i + 1]))
    return np.array(rows, np.int64).reshape(-1, 3)


def revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def read_contigs(prefix: str) -> Dict[int, bytes]:
    """Contig id -> sequence: the ``.contig`` records, and for each
    record that ``.ContigIndex`` marks as having a reverse complement,
    that complement at the next id."""
    seqs = {int(h.split()[0]): s for h, s in read_fasta(prefix + ".contig")}
    with open(prefix + ".ContigIndex") as fh:
        lines = fh.read().split("\n")[2:]
    for line in lines:
        f = line.split()
        if len(f) == 3 and f[2] == "1" and int(f[0]) in seqs:
            i = int(f[0])
            seqs[i + 1] = revcomp(seqs[i])
    return seqs


def read_placements(path: str) -> np.ndarray:
    """(P, 4) int64 rows (read number, contig id, position, +1 or -1)
    of ``.readOnContig``."""
    with open(path) as fh:
        fh.readline()
        cols = np.array(fh.read().split()).reshape(-1, 4)
    out = np.empty(cols.shape, np.int64)
    out[:, :3] = cols[:, :3].astype(np.int64)
    out[:, 3] = np.where(cols[:, 3] == "+", 1, -1)
    return out


# ---- the checks ---------------------------------------------------------

def _unread(kmers: ReadKmers, seqs: List[bytes], k: int, device) -> int:
    vals, ok, _ = _records_kmers(seqs, k, device)
    return int((ok & ~kmers.contains(vals)).sum())


def kmerfreq_bins_off(kmers: ReadKmers, path: str) -> int:
    with open(path) as fh:
        got = np.array([int(x) for x in fh.read().split()], np.int64)
    want = kmers.histogram()
    if got.shape != want.shape:
        return MAX_FREQ - 1
    return int((got != want).sum())


def edge_checks(kmers: ReadKmers, seqs: List[bytes], k: int,
                device) -> Tuple[int, int]:
    """(edge_kmers_unread, edge_kmers_shared)."""
    vals, ok, rec = _records_kmers(seqs, k, device)
    unread = int((ok & ~kmers.contains(vals)).sum())
    # inside: neither the first nor the last window of its record
    lens = torch.tensor([len(s) - k + 1 for s in seqs], device=device)
    start = torch.cumsum(lens + k, 0) - (lens + k)
    pos = torch.arange(vals.shape[0], device=device) - start[rec]
    inside = ok & (pos > 0) & (pos < lens[rec] - 1)
    pairs = torch.unique(torch.stack([vals[inside], rec[inside]]), dim=1)
    _, per_kmer = torch.unique(pairs[0], return_counts=True)
    return unread, int((per_kmer > 1).sum())


def arcs_unjoined(edges: Dict[int, bytes], arcs: np.ndarray,
                  k: int) -> int:
    bad = 0
    for f, t, m in arcs.tolist():
        a, b = edges.get(f), edges.get(t)
        if a is None or b is None or m < 1 or a[-k:] != b[:k]:
            bad += 1
    return bad


def arcs_missing(reads: np.ndarray, edges: Dict[int, bytes],
                 arcs: np.ndarray, k: int, device,
                 block_rows: int = 1 << 18) -> int:
    """Junctions (e1, e2) through the vertex K-mer that ends e1 and
    starts e2, both with an inner K-mer beside it, that a read walks
    through but ``.preArc`` does not list."""
    starts: Dict[bytes, List[int]] = {}
    for i, s in edges.items():
        if len(s) >= k + 2:
            starts.setdefault(s[:k], []).append(i)
    junc, walk = [], []
    for i, s in edges.items():
        if len(s) < k + 2:
            continue
        for j in starts.get(s[-k:], ()):
            if j != i:
                junc.append((i, j))
                walk.append(s[-(k + 1):] + edges[j][k:k + 1])
    if not junc:
        return 0
    jkey = pair_keys(_joined_codes(walk, device), k)[::k + 3]
    seen = []
    for lo in range(0, reads.shape[0], block_rows):
        key = pair_keys(_read_block(reads, lo, block_rows, device).reshape(
            -1), k)
        seen.append(torch.unique(key[key != -1]))
    walked = torch.isin(jkey, torch.cat(seen)).cpu().numpy()
    listed = set(map(tuple, arcs[:, :2].tolist()))
    return sum(1 for (i, j), w in zip(junc, walked)
               if w and (i, j) not in listed)


def transcript_pieces_off(prefix: str, contigs: Dict[int, bytes]) -> int:
    scaf = {h.split()[0]: s for h, s in read_fasta(prefix + ".scafSeq")}
    covered = {name: np.zeros(len(s), bool) for name, s in scaf.items()}
    bad = 0
    name = None
    with open(prefix + ".contigPosInscaff") as fh:
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                continue
            c, st, strand, ln = line.split()
            c, st, ln = int(c), int(st), int(ln)
            seq = contigs.get(c, b"")
            if strand == "-":
                seq = revcomp(seq)
            piece = scaf.get(name, b"")[st:st + ln]
            if name not in scaf or len(piece) != ln or piece not in seq:
                bad += 1
            else:
                covered[name][st:st + ln] = True
    for name, s in scaf.items():
        if name.startswith("C") and name[1:].isdigit():
            c = contigs.get(int(name[1:]) + 1, b"")  # C<row>: id - 1
            bad += int(s not in c and s not in revcomp(c))
        else:
            text = np.frombuffer(s.upper(), np.uint8)
            bad += int(((text != ord("N")) & ~covered[name]).any())
    return bad


def placements_off(reads: np.ndarray, contigs: Dict[int, bytes],
                   rows: np.ndarray, k: int, device,
                   block: int = 1 << 16) -> int:
    """Rows whose read shares no K-mer with the contig on the stated
    diagonal: read base i against contig base pos + i.  (The contig id
    already names the strand: a read that lies on the reverse
    complement of a printed contig is placed on its twin's id.)"""
    if rows.shape[0] == 0:
        return 0
    n_id = max(contigs) + 1
    seqs = [contigs.get(i, b"") for i in range(n_id)]
    # forward values: the contig id names the strand
    vals, _, ok = strand_values(_joined_codes(seqs, device), k)
    vals = torch.where(ok, vals, -1)
    start = torch.tensor(np.cumsum([0] + [len(s) + 1 for s in seqs])[:-1],
                         device=device)
    lens = torch.tensor([len(s) for s in seqs], device=device)
    bad = 0
    length = reads.shape[1]
    for lo in range(0, rows.shape[0], block):
        r = torch.from_numpy(rows[lo:lo + block]).to(device)
        if (r[:, 0] < 1).any() or (r[:, 0] > reads.shape[0]).any() or \
                (r[:, 1] < 1).any() or (r[:, 1] >= n_id).any():
            bad += int(r.shape[0])
            continue
        rd = _read_block(reads[(r[:, 0] - 1).cpu().numpy()], 0,
                         r.shape[0], device)
        rv, _, rok = strand_values(rd.reshape(-1), k)
        w = length - k + 1
        rv = torch.cat([rv, rv.new_full((k - 1,), -2)]).view(
            -1, length + 1)[:, :w]
        rok = torch.cat([rok, rok.new_zeros(k - 1)]).view(
            -1, length + 1)[:, :w]
        cpos = r[:, 2:3] + torch.arange(w, device=device)[None, :]
        c = r[:, 1:2]
        inside = (cpos >= 0) & (cpos <= lens[c] - k)
        cv = vals[(start[c] + cpos.clamp(min=0)).clamp(
            max=vals.shape[0] - 1)]
        hit = inside & rok & (cv == rv)
        bad += int((~hit.any(1)).sum())
    return bad


def kmers_missing(kmers: ReadKmers, seqs: List[bytes], k: int,
                  device) -> Tuple[int, int]:
    """K-mers read at least ``SOLID`` times that lie in none of
    ``seqs``, and all K-mers read that often."""
    vals, ok, _ = _records_kmers(seqs, k, device)
    solid = kmers.keys[kmers.count >= SOLID]
    missing = int((~torch.isin(solid, torch.unique(vals[ok]))).sum())
    return missing, int(solid.numel())


def reads_unplaced(reads: np.ndarray, printed: Dict[int, bytes],
                   rows: np.ndarray, k: int, device,
                   block: int = 1 << 16) -> int:
    """Reads that the map step's rule places but ``.readOnContig`` does
    not list.  ``printed``: the ``.contig`` records, one of each twin
    pair, whose K-mers both strands share."""
    ids = [i for i, s in sorted(printed.items()) if len(s) >= k + 2]
    vals, ok, rec = _records_kmers([printed[i] for i in ids], k, device)
    keys, inv, cnt = torch.unique(vals[ok], return_inverse=True,
                                  return_counts=True)
    owner = torch.full_like(keys, -1)
    owner[inv] = rec[ok]
    owner = torch.where(cnt == 1, owner, -1)  # K-mers of one window only
    if keys.numel() == 0:
        return 0
    length = reads.shape[1]
    multi = max(5, min(length, MAP_LEN) - k + 1)
    w = length - k + 1
    n_ctg = len(ids) + 1
    placed = np.zeros(reads.shape[0] + 1, bool)
    placed[rows[:, 0][(rows[:, 0] >= 1) & (rows[:, 0] <= reads.shape[0])]] \
        = True
    missed = 0
    for lo in range(0, reads.shape[0], block):
        rd = _read_block(reads, lo, block, device)
        rv, rok = kmer_values(rd.reshape(-1), k)
        n = rd.shape[0]
        rv = torch.cat([rv, rv.new_zeros(k - 1)]).view(n, length + 1)[:, :w]
        rok = torch.cat([rok, rok.new_zeros(k - 1)]).view(
            n, length + 1)[:, :w]
        i = torch.searchsorted(keys, rv.contiguous()).clamp(
            max=keys.shape[0] - 1)
        hit = torch.where(rok & (keys[i] == rv), owner[i], -1)
        row = torch.arange(n, device=device)[:, None].expand(n, w)
        key = (row * n_ctg + hit)[hit >= 0]
        grp, votes = torch.unique(key, return_counts=True)
        due = torch.unique(grp[votes >= multi] // n_ctg).cpu().numpy()
        missed += int((~placed[lo + 1 + due]).sum())
    return missed


def contigs_unscaffolded(prefix: str, printed: Dict[int, bytes],
                         twin_of: Dict[int, int]) -> int:
    """Printed contigs of >= ``SINGLETON_MIN`` bp that no ``.scafSeq``
    record holds: neither a singleton ``C<id - 1>`` nor a piece that
    ``.contigPosInscaff`` places, of them or of their twins."""
    held = set()
    for h, _ in read_fasta(prefix + ".scafSeq"):
        name = h.split()[0]
        if name.startswith("C") and name[1:].isdigit():
            held.add(int(name[1:]) + 1)
    with open(prefix + ".contigPosInscaff") as fh:
        for line in fh:
            if not line.startswith(">") and line.strip():
                held.add(int(line.split()[0]))
    return sum(1 for c, s in printed.items() if len(s) >= SINGLETON_MIN
               and c not in held and twin_of.get(c, c) not in held)


def check(prefix: str, reads: np.ndarray, k: int,
          device) -> Dict[str, float]:
    """Every number compared, for the stage files at ``prefix`` of an
    assembly of ``reads`` ((R, L) codes in read-number order)."""
    kmers = ReadKmers(reads, k, device)
    out = {"kmerfreq_bins_off": kmerfreq_bins_off(
        kmers, prefix + ".kmerFreq")}
    edges, ids = read_edges(prefix + ".edge.gz", k)
    out["edge_kmers_unread"], out["edge_kmers_shared"] = edge_checks(
        kmers, [edges[i] for i in ids], k, device)
    arcs = read_arcs(prefix + ".preArc")
    out["arcs_unjoined"] = arcs_unjoined(edges, arcs, k)
    out["arcs_missing"] = arcs_missing(reads, edges, arcs, k, device)
    missing, solid = kmers_missing(kmers, [edges[i] for i in ids], k,
                                   device)
    out["edge_kmers_missing_pct"] = 100.0 * missing / max(solid, 1)
    contigs = read_contigs(prefix)
    printed = {int(h.split()[0]): s
               for h, s in read_fasta(prefix + ".contig")}
    twin_of = {i: i + 1 for i in printed if i + 1 in contigs
               and i + 1 not in printed}
    seqs = [contigs[i] for i in sorted(contigs)]
    out["contig_kmers_unread"] = _unread(kmers, seqs, k, device)
    missing, solid = kmers_missing(kmers, seqs, k, device)
    out["contig_kmers_missing_pct"] = 100.0 * missing / max(solid, 1)
    rows = read_placements(prefix + ".readOnContig")
    out["placements_off"] = placements_off(reads, contigs, rows, k, device)
    out["reads_unplaced"] = reads_unplaced(reads, printed, rows, k, device)
    out["transcript_pieces_off"] = transcript_pieces_off(prefix, contigs)
    out["contigs_unscaffolded"] = contigs_unscaffolded(
        prefix, printed, twin_of)
    return out
