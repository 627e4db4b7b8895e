"""Pregraph and contig stage-file writers (reference-compatible formats).

A jax-free copy of ``write_kmer_freq``, ``write_pregraph_basic``,
``write_pe_grads``, ``write_contig_fasta`` and ``write_contig_index``
from ``soapdenovo_trans_tpu/io/stagefiles.py``, which imports the JAX
package's ``ops/bits`` (and so ``jax``); the machine that runs the port
on the GPU has no jax.  The contig writers take the port's tensors.
"""

from __future__ import annotations

from typing import List

import numpy as np


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
