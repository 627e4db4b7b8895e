"""Reference-format pregraph files: .vertex / .edge.gz / .preArc.

A jax-free copy of ``write_pregraph_files``, ``edge_file_ids`` and the
hex helpers of ``soapdenovo_trans_tpu/io/graph_files.py``, which imports
``jax`` at module level; the machine that runs the port on the GPU has
no jax.  The writers take the port's tensors and read them on the host.

* .vertex  — branch-kmer hex dump, 8 per line (reference
  output_pregraph.c:47-81, print_kmer kmer.c:499-516);
* .edge.gz — one record per canonical edge pair:
  ``>length L,<from kmer hex>,<to kmer hex>,cvg C, B`` + sequence
  (100/line) (output_pregraph.c:83-100);
* .preArc  — ``from to1 m1 to2 m2 ...`` with 1-based edge ids
  (prlRead2path.c output_arcs).

Hex follows the compile-time MER variant the reference would use for
this K: one u64 for K<=31, "high low" for K<=63, four words for K<=127.
"""

from __future__ import annotations

import gzip
from typing import List

import numpy as np

from ..ops import bits


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
    (for .preGraphBasic's VERTEX field)."""
    keys = _host(table.keys)
    n_e = edges.n_edges
    from_node = _host(edges.from_node[:n_e])
    to_node = _host(edges.to_node[:n_e])
    length = _host(edges.length[:n_e])
    cvg = _host(edges.cvg[:n_e])
    twin = _host(edges.twin[:n_e])
    seq_off = _host(edges.seq_off[:n_e])
    pool = _host(edges.seq_pool)

    # vertex set: canonical rows of all live edge endpoints
    rows = np.unique(np.concatenate([from_node, to_node]) >> 1)
    with open(prefix + ".vertex", "w") as fh:
        for i, r in enumerate(rows):
            fh.write(_kmer_hex(keys[r], k) + " ")
            if (i + 1) % 8 == 0:
                fh.write("\n")
        fh.write("\n")

    # edges: rep first, twin implicit
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
            fh.write(f">length {ln},{fk},{tk},cvg {int(cvg[e])}, {bal}\n")
            s = pool[int(seq_off[e]): int(seq_off[e]) + ln]
            line = "".join(bits.BASE_CHARS[b] for b in s)
            for j in range(0, max(ln, 1), 100):
                fh.write(line[j: j + 100] + "\n")

    a_n = arcs.n
    f = _host(arcs.from_ed[:a_n])
    t = _host(arcs.to_ed[:a_n])
    m = _host(arcs.mult[:a_n])
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
