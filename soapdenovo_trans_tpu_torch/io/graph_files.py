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
"""

from __future__ import annotations

import gzip
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


def _oriented_kmer(table_keys: np.ndarray, node: int, k: int) -> int:
    """Directed node id (2*row + s) -> oriented kmer integer."""
    row, s = node >> 1, node & 1
    v = _lanes_to_int(table_keys[row])
    return _revcomp_int(v, k) if s else v


def edge_file_ids(edges):
    """Edge row -> 1-based .edge.gz file id (rep first, twin = id+1 —
    the reference loader's bal_edge convention, loadPreGraph.c:543).
    Returns (file_id (n_e,) int64, rep rows in file order, next id)."""
    n_e = edges.n_edges
    twin = _host(edges.twin[:n_e])
    file_id = np.zeros(n_e, np.int64)
    nxt = 1
    order: List[int] = []
    for e in range(n_e):
        t = int(twin[e])
        if t == e:
            file_id[e] = nxt
            order.append(e)
            nxt += 1
        elif file_id[e] == 0:
            file_id[e] = nxt
            if 0 <= t < n_e:
                file_id[t] = nxt + 1
            order.append(e)
            nxt += 2
    return file_id, order, nxt


def write_pregraph_files(prefix: str, table, edges, arcs, k: int) -> int:
    """Write .vertex, .edge.gz and .preArc; returns the vertex count
    (for .preGraphBasic's VERTEX field).  Spans: the device-to-host
    copies ``pregraph.write.host``, then ``pregraph.write.vertex``,
    ``.edge`` and ``.arc``, one a file."""
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

    # vertex set: canonical rows of all live edge endpoints
    with profiling.span("pregraph.write.vertex"):
        rows = np.unique(np.concatenate([from_node, to_node]) >> 1)
        with open(prefix + ".vertex", "w") as fh:
            for i, r in enumerate(rows):
                fh.write(_kmer_hex(keys[r], k) + " ")
                if (i + 1) % 8 == 0:
                    fh.write("\n")
            fh.write("\n")

    # edges: rep first, twin implicit
    with profiling.span("pregraph.write.edge"):
        file_id, order, _nxt = edge_file_ids(edges)
        w = bits.words_for_k(k)
        with gzip.open(prefix + ".edge.gz", "wt") as fh:
            for e in order:
                fk = _kmer_hex(_int_to_lanes(
                    _oriented_kmer(keys, int(from_node[e]), k), w), k)
                tk = _kmer_hex(_int_to_lanes(
                    _oriented_kmer(keys, int(to_node[e]), k), w), k)
                bal = 0 if int(twin[e]) == e else 1
                ln = int(length[e])
                fh.write(f">length {ln},{fk},{tk},cvg {int(cvg[e])}, "
                         f"{bal}\n")
                s = pool[int(seq_off[e]): int(seq_off[e]) + ln]
                line = "".join(bits.BASE_CHARS[b] for b in s)
                for j in range(0, max(ln, 1), 100):
                    fh.write(line[j: j + 100] + "\n")

    with profiling.span("pregraph.write.arc"):
        by_from: dict = {}
        for i in range(a_n):
            by_from.setdefault(int(file_id[f[i]]), []).append(
                (int(file_id[t[i]]), int(m[i])))
        with open(prefix + ".preArc", "w") as fh:
            for fe in sorted(by_from):
                parts = [str(fe)]
                for te, mm in by_from[fe]:
                    parts.append(f"{te} {mm}")
                fh.write(" ".join(parts) + "\n")
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


def _oriented_lanes(table, nodes: torch.Tensor, k: int) -> np.ndarray:
    """Directed node ids (2*row + s) -> oriented k-mer lanes, (n, W)."""
    km = table.keys[nodes.clamp(min=0) >> 1]
    rc = ((nodes & 1) == 1)[:, None]
    return torch.where(rc, bits.reverse_complement(km, k), km).cpu().numpy()


def write_contig_graph_files(prefix: str, ctg, table, k: int,
                             perm: List[int]) -> None:
    """.updated.edge + .Arc in the .contig/.ContigIndex numbering
    (perm: new id - 1 -> contig row, from write_contig_fasta)."""
    n = ctg.n
    length = _host(ctg.length[:n])
    cvg = _host(ctg.cvg[:n])
    twin = _host(ctg.twin[:n])
    from_km = _oriented_lanes(table, ctg.from_node[:n], k)
    to_km = _oriented_lanes(table, ctg.to_node[:n], k)
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
