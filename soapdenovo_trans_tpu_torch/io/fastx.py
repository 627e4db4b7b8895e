"""FASTA/FASTQ readers -> padded uint8 read batches, and the FASTA writer.

A jax-free copy of ``config_read_batches`` and what it calls, and of
``write_fasta``, from ``soapdenovo_trans_tpu/io/fastx.py``: that module
imports the JAX package's ``ops/bits`` (and so ``jax``), and the machine
that runs the port on the GPU has no jax.  ``_CHAR2CODE`` comes from this
package's ``ops/bits``; ``libconfig``, ``bam`` and ``native`` are this
package's copies, so the port loads no module of the JAX package.

Reads stream in as (B, L) uint8 code batches (A=0,C=1,T=2,G=3,N=4),
padded to a fixed width; paired files are interleaved read1,read2,...
(attachPEinfo.c pairs consecutive read indices) and ``reverse_seq=1``
libraries are reverse-complemented on input (readseq1by1.c:749).
"""

from __future__ import annotations

import gzip
import io
import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..ops.bits import _CHAR2CODE
from ..utils import profiling
from . import bam, native
from .libconfig import Config, LibInfo

_COMP = np.array([2, 3, 0, 1, 4], dtype=np.uint8)  # b -> b^2, N fixed


def _open(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path)


def read_fasta(path: str) -> Iterator[str]:
    seq: List[str] = []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line[0] == ">":
                if seq:
                    yield "".join(seq)
                    seq = []
            else:
                seq.append(line)
        if seq:
            yield "".join(seq)


def read_fastq(path: str) -> Iterator[str]:
    with _open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            s = fh.readline().strip()
            fh.readline()  # +
            fh.readline()  # qual
            yield s


def _reader_for(path: str) -> Iterator[str]:
    base = path[:-3] if path.endswith(".gz") else path
    if base.endswith((".fq", ".fastq")):
        return read_fastq(path)
    return read_fasta(path)


def _interleave(a: Iterator[str], b: Iterator[str]) -> Iterator[str]:
    for r1 in a:
        r2 = next(b, None)
        if r2 is None:
            raise ValueError("paired files have unequal read counts")
        yield r1
        yield r2


def lib_reads(lib: LibInfo) -> Iterator[str]:
    """All reads of one library: paired sources first (interleaved),
    then singles — mirroring openFileInLib's source rotation
    (readseq1by1.c:697)."""
    for b in lib.b:
        yield from bam.read_bam(b)
    for fa1, fa2 in zip(lib.f1, lib.f2):
        yield from _interleave(_reader_for(fa1), _reader_for(fa2))
    for fq1, fq2 in zip(lib.q1, lib.q2):
        yield from _interleave(_reader_for(fq1), _reader_for(fq2))
    for p in lib.p:
        yield from _reader_for(p)
    for f in lib.f + lib.q:
        yield from _reader_for(f)


def encode_read(s: str, max_len: int, reverse: bool) -> np.ndarray:
    codes = _CHAR2CODE[np.frombuffer(s.upper().encode(), np.uint8)]
    if reverse:
        codes = _COMP[codes[::-1]]
    return codes[:max_len]


def _prefetch(it, depth: int = 2):
    """Double-buffered read-ahead: decode the next batches on a
    background thread while the caller computes/moves the current one
    — the aio analog (reference initAIO/AIORead,
    prlHashReads.c:709-806).  Both batch producers allocate fresh
    buffers per yield, so handing them across the thread is safe.

    The run's recorder (``utils/profiling``) gets the counter
    ``reads.decode_s``, the thread's seconds producing each batch, and
    the span ``reads.wait`` around each wait of the caller for one."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    rec = profiling.recorder()

    def worker():
        try:
            t0 = time.perf_counter()
            for x in it:
                rec.counter("reads.decode_s", time.perf_counter() - t0)
                q.put(x)
                t0 = time.perf_counter()
            q.put(sentinel)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        with rec.span("reads.wait"):
            x = q.get()
        if x is sentinel:
            return
        if isinstance(x, BaseException):
            raise x
        yield x


def config_read_batches(
    cfg: Config,
    batch_size: int,
    max_len: int | None = None,
    purpose: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """Yield (codes (B, L) uint8, lengths (B,), lib_index) batches for
    all libraries whose asm_flags include ``purpose`` (1 = contig
    building, 2 = mapping/scaffolding; reference asm_flags).

    The final batch of each library is zero-padded to batch_size so
    batch shapes stay static; padded rows have length 0.  Reads are
    globally ordered lib-by-lib with pairs adjacent, preserving the
    reference's read numbering for PE pairing.  Decoding runs on a
    read-ahead thread (see _prefetch).
    """
    return _prefetch(_config_read_batches(
        cfg, batch_size, max_len=max_len, purpose=purpose))


def _config_read_batches(
    cfg: Config,
    batch_size: int,
    max_len: int | None = None,
    purpose: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    max_len = max_len or cfg.max_rd_len
    for li, lib in enumerate(cfg.libs):
        if not (lib.asm_flags & purpose):
            continue
        cutoff = lib.rd_len_cutoff or max_len
        eff_len = min(max_len, cutoff)

        # Fast path: libraries made only of single-stream sources
        # (BAM, singles and pre-interleaved `p` pairs) with no
        # on-input transform stream through the native C++ decoder;
        # source order matches lib_reads (b, p, f, q).
        simple = (not lib.f1 and not lib.q1 and
                  not lib.reverse_seq and native.available())
        if simple:
            for path in lib.b + list(lib.p) + lib.f + lib.q:
                for codes, lens in native.read_batches(
                        path, batch_size, eff_len):
                    yield codes, lens, li
            continue

        buf = np.zeros((batch_size, eff_len), dtype=np.uint8)
        lens = np.zeros(batch_size, dtype=np.int32)
        fill = 0
        for s in lib_reads(lib):
            codes = encode_read(s, eff_len, bool(lib.reverse_seq))
            buf[fill, : len(codes)] = codes
            buf[fill, len(codes):] = 4
            lens[fill] = len(codes)
            fill += 1
            if fill == batch_size:
                yield buf, lens, li
                buf = np.zeros((batch_size, eff_len), dtype=np.uint8)
                lens = np.zeros(batch_size, dtype=np.int32)
                fill = 0
        if fill:
            buf[fill:] = 4
            lens[fill:] = 0
            yield buf, lens, li


def write_fasta(path: str, records: Sequence[Tuple[str, str]],
                width: int = 100) -> None:
    with open(path, "w") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i: i + width] + "\n")
