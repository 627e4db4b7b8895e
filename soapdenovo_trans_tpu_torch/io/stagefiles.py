"""Pregraph stage-file writers (reference-compatible formats).

A jax-free copy of ``write_kmer_freq``, ``write_pregraph_basic`` and
``write_pe_grads`` from ``soapdenovo_trans_tpu/io/stagefiles.py``, which
imports the JAX package's ``ops/bits`` (and so ``jax``); the machine
that runs the port on the GPU has no jax.
"""

from __future__ import annotations

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
