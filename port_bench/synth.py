"""Synthetic RNA-seq reads, made from a seed.

A frozen, vectorised copy of ``perf_e2e.synth`` (repository root), which
stays where it is: random transcripts of ``tx_len`` bases, an SNP
isoform for a share of them, paired reads of ``read_len`` bases from
fragments of ``insert`` bases (the second mate reverse-complemented),
and substitution errors at ``err`` a base.  What this copy adds: the
expression law (``uniform``, or ``lognormal`` with ``sigma``: each
sequence of the pool is drawn with a weight e^N(0, sigma^2), one set of
weights for every seed, dealt in an order drawn from the seed), the read
length and insert as parameters, and a FASTA writer with no Python loop
over reads.  With the law ``uniform`` and the defaults of
``perf_e2e`` the random stream is the one ``perf_e2e.synth`` draws.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

CODE = np.frombuffer(b"ACGT", np.uint8)


@dataclasses.dataclass
class Reads:
    """The generated data: the transcript pool (transcripts, then their
    isoforms) and both mates' bases as codes 0-3 (A, C, G, T)."""

    pool: np.ndarray   # (T, tx_len) int8
    r1: np.ndarray     # (P, read_len) int8
    r2: np.ndarray     # (P, read_len) int8

    def interleaved(self) -> np.ndarray:
        """(2P, read_len): the reads in the order the assembler numbers
        them, mate 1 then mate 2 of each pair."""
        out = np.empty((2 * self.r1.shape[0], self.r1.shape[1]), np.int8)
        out[0::2], out[1::2] = self.r1, self.r2
        return out


def n_pairs(config: dict, read_len: int) -> int:
    """A configuration's read bases over the bases of one pair, rounded
    up."""
    return -(-int(config["read_bases"]) // (2 * read_len))


def expression_weights(rng, n: int, expression: str,
                       sigma: float) -> np.ndarray:
    """Each pool sequence's weight: one set for every seed, dealt in an
    order drawn from ``rng``, so that the seed moves which sequence is
    deep and not how deep the sequences are."""
    if expression != "lognormal":
        raise ValueError(f"unknown expression law {expression!r}")
    fixed = np.random.default_rng(0).normal(0.0, sigma, size=n)
    return rng.permutation(np.exp(fixed))


def make_reads(seed: int, n_tx: int, pairs: int, read_len: int,
               insert: int, tx_len: int = 1500, isoform_share: float = 0.5,
               err: float = 0.002, expression: str = "uniform",
               sigma: float = 0.0) -> Reads:
    """The transcripts and both mates' reads of one dataset."""
    if insert < read_len or insert > tx_len:
        raise ValueError("need read_len <= insert <= tx_len")
    rng = np.random.default_rng(seed)
    txs = rng.integers(0, 4, size=(n_tx, tx_len), dtype=np.int8)
    iso = txs[: int(n_tx * isoform_share)].copy()
    pos = rng.integers(200, tx_len - 200, size=iso.shape[0])
    rows = np.arange(iso.shape[0])
    iso[rows, pos] = (iso[rows, pos] + 1) % 4
    pool = np.concatenate([txs, iso])

    if expression == "uniform":
        t_idx = rng.integers(0, pool.shape[0], size=pairs)
    else:
        w = expression_weights(rng, pool.shape[0], expression, sigma)
        t_idx = rng.choice(pool.shape[0], size=pairs, p=w / w.sum())
    s = rng.integers(0, tx_len - insert + 1, size=pairs)
    offs = np.arange(read_len)
    r1 = pool[t_idx[:, None], s[:, None] + offs]
    r2 = pool[t_idx[:, None], s[:, None] + insert - read_len + offs]
    r2 = 3 - r2[:, ::-1]  # reverse complement: comp(b) = 3 - b
    for r in (r1, r2):
        n_err = int(err * r.size)
        ei = rng.integers(0, r.shape[0], size=n_err)
        ej = rng.integers(0, r.shape[1], size=n_err)
        r[ei, ej] = (r[ei, ej] + rng.integers(1, 4, size=n_err)) % 4
    return Reads(pool, np.ascontiguousarray(r1), np.ascontiguousarray(r2))


def write_fasta(path: str, reads: np.ndarray) -> None:
    """One record a row, ``>r<9 digits>`` then the bases on one line,
    written as one block of bytes."""
    n, length = reads.shape
    if n >= 10**9:
        raise ValueError("too many reads for 9-digit names")
    digits = (np.arange(n)[:, None] // 10 ** np.arange(8, -1, -1)) % 10
    rec = np.empty((n, 2 + 9 + 1 + length + 1), np.uint8)
    rec[:, 0], rec[:, 1] = ord(">"), ord("r")
    rec[:, 2:11] = ord("0") + digits
    rec[:, 11] = ord("\n")
    rec[:, 12:12 + length] = CODE[reads]
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def write_dataset(workdir: str, reads: Reads, read_len: int,
                  insert: int) -> str:
    """Both mates' FASTA and a one-library ``lib.config`` (the
    reference's [LIB] format, as ``perf_e2e.synth`` writes it); returns
    the config's path."""
    os.makedirs(workdir, exist_ok=True)
    fa1 = os.path.join(workdir, "reads_1.fa")
    fa2 = os.path.join(workdir, "reads_2.fa")
    write_fasta(fa1, reads.r1)
    write_fasta(fa2, reads.r2)
    cfg = os.path.join(workdir, "lib.config")
    with open(cfg, "w") as fh:
        fh.write(f"max_rd_len={read_len}\n[LIB]\navg_ins={insert}\n"
                 f"reverse_seq=0\nasm_flags=3\nf1={fa1}\nf2={fa2}\n")
    return cfg
