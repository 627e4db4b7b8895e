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

Two decoders make the same batches: the native one (``io/native``, C++,
run without the GIL) and the per-read Python one (``lib_reads`` and
``encode_read``).  Every library with ``reverse_seq=0`` takes the native
one where it builds, a paired library's mates each in its own stream,
interleaved by rows here, unless a sniff of a source's first 64 KiB
(``_native_alike``) finds what the two decoders read differently (CR
line ends, blank FASTQ lines, a FASTA record with no bases, ...).
"""

from __future__ import annotations

import contextlib
import gzip
import io
import time
import zlib
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


def _is_fastq(path: str) -> bool:
    base = path[:-3] if path.endswith(".gz") else path
    return base.endswith((".fq", ".fastq"))


def _reader_for(path: str) -> Iterator[str]:
    if _is_fastq(path):
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
    prlHashReads.c:709-806).  ``it`` yields (codes, lens, li, native);
    the caller gets (codes, lens, li).  Every batch producer allocates
    fresh buffers per yield, so handing them across the thread is safe.

    The run's recorder (``utils/profiling``) gets the counters
    ``reads.decode_s``, the thread's seconds producing each batch,
    ``reads.batches`` and ``reads.batches_native``, the batches made
    and those the native decoder made, and the span ``reads.wait``
    around each wait of the caller for one."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    rec = profiling.recorder()

    def worker():
        try:
            t0 = time.perf_counter()
            for codes, lens, li, nat in it:
                rec.counter("reads.decode_s", time.perf_counter() - t0)
                rec.counter("reads.batches", 1)
                rec.counter("reads.batches_native", int(nat))
                q.put((codes, lens, li))
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
    read-ahead thread (see _prefetch), by the native decoder where it
    reads a library as the Python one does (see _native_alike).
    """
    return _prefetch(_config_read_batches(
        cfg, batch_size, max_len=max_len, purpose=purpose))


def _config_read_batches(
    cfg: Config,
    batch_size: int,
    max_len: int | None = None,
    purpose: int = 1,
) -> Iterator[Tuple[np.ndarray, np.ndarray, int, bool]]:
    """config_read_batches's batches, each with whether the native
    decoder made it."""
    max_len = max_len or cfg.max_rd_len
    for li, lib in enumerate(cfg.libs):
        if not (lib.asm_flags & purpose):
            continue
        cutoff = lib.rd_len_cutoff or max_len
        eff_len = min(max_len, cutoff)

        if not lib.reverse_seq and native.available():
            # Libraries made only of single-stream sources (BAM,
            # singles and pre-interleaved `p` pairs) yield each source's
            # batches, the last one padded; source order matches
            # lib_reads (b, p, f, q).
            if not lib.f1 and not lib.q1:
                for path in lib.b + list(lib.p) + lib.f + lib.q:
                    for codes, lens in native.read_batches(
                            path, batch_size, eff_len):
                        yield codes, lens, li, True
                continue
            # A paired library fills its batches across sources, as
            # the Python loop below does.
            if _lib_alike(lib):
                for codes, lens in _rebatch(
                        _native_rows(lib, batch_size, eff_len),
                        batch_size, eff_len):
                    yield codes, lens, li, True
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
                yield buf, lens, li, False
                buf = np.zeros((batch_size, eff_len), dtype=np.uint8)
                lens = np.zeros(batch_size, dtype=np.int32)
                fill = 0
        if fill:
            buf[fill:] = 4
            lens[fill:] = 0
            yield buf, lens, li, False


def _lib_alike(lib: LibInfo) -> bool:
    """Whether the native decoder reads every source of ``lib`` as the
    Python readers do (see _native_alike)."""
    text = lib.f1 + lib.f2 + lib.q1 + lib.q2 + list(lib.p) + lib.f + lib.q
    return (all(_native_alike(path, True) for path in lib.b) and
            all(_native_alike(path, False) for path in text))


_SNIFF = 1 << 16
# What a sequence line may hold for the two decoders to read it alike:
# printable ASCII without the space (``str.strip`` drops it at a line's
# ends, the native decoder keeps it as an N) and without '>' (the native
# FASTA parser takes one that opens its 1 MiB block for a header).
_SEQ_BYTES = bytes(c for c in range(0x21, 0x7F) if c != ord(">"))


def _native_alike(path: str, is_bam: bool) -> bool:
    """Whether the native decoder reads ``path`` as the Python reader
    does, judged by its first 64 KiB: a BAM by its magic; a FASTA or
    FASTQ (by its name, as ``_reader_for`` chooses) by ``_text_alike``.
    A source that cannot be opened is left to the Python reader, which
    raises what the user should see."""
    try:
        if is_bam:
            with gzip.open(path, "rb") as fh:
                return fh.read(4) == b"BAM\x01"
        with (gzip.open if path.endswith(".gz") else open)(path, "rb") as fh:
            head = fh.read(_SNIFF + 1)
    except (OSError, EOFError, zlib.error):
        return False
    return _text_alike(head[:_SNIFF], len(head) <= _SNIFF, _is_fastq(path))


def _text_alike(head: bytes, whole: bool, fastq: bool) -> bool:
    """Whether ``head``, the start of a FASTA or FASTQ file (all of it
    where ``whole``), holds nothing that ``read_fasta`` / ``read_fastq``
    and the native decoder read differently: ASCII only and no CR (text
    mode ends a line there); each sequence line of ``_SEQ_BYTES``; in
    FASTA a header first and no record without bases (the Python reader
    drops it, the native one yields a read of length 0); in FASTQ
    four-line records, '@' and '+' where they belong, the quality line
    no shorter than the bases (the native decoder reads on to the next
    line for the rest) and no blank line between records (the Python
    reader takes it for a header)."""
    if not head.isascii() or b"\r" in head:
        return False
    lines = head.split(b"\n")
    if not whole or lines[-1] == b"":
        lines.pop()  # cut by the sniff, or the empty tail after a newline
    if fastq:
        if whole and len(lines) % 4:
            return False
        for i in range(0, len(lines) - 3, 4):
            h, seq, plus, qual = lines[i: i + 4]
            if (h[:1] != b"@" or plus[:1] != b"+" or len(qual) < len(seq)
                    or seq.translate(None, _SEQ_BYTES)):
                return False
        return True
    header = None  # whether the last non-blank line was a header
    for line in lines:
        if not line:
            continue
        if line[:1] == b">":
            if header:
                return False
            header = True
        elif header is None or line.translate(None, _SEQ_BYTES):
            return False
        else:
            header = False
    return not (whole and header)


def _native_rows(lib: LibInfo, batch_size: int, eff_len: int):
    """A paired library's reads in lib_reads's order, as unpadded
    (codes, lens) blocks of the native decoder: each mate's file in
    blocks of half a batch, interleaved by rows."""
    for path in lib.b:
        yield from native.read_rows(path, batch_size, eff_len)
    half = max(batch_size // 2, 1)
    for m1, m2 in list(zip(lib.f1, lib.f2)) + list(zip(lib.q1, lib.q2)):
        yield from _interleave_rows(native.read_rows(m1, half, eff_len),
                                    native.read_rows(m2, half, eff_len))
    for path in list(lib.p) + lib.f + lib.q:
        yield from native.read_rows(path, batch_size, eff_len)


def _interleave_rows(a, b):
    """Two mates' block streams as one, read1, read2, ...  As
    ``_interleave``: mate 2 running out first raises, once the pairs
    before have been yielded; mate 1 running out first drops the rest
    of mate 2.  Both streams come in blocks of one size, so block i of
    each holds the same reads."""
    with contextlib.closing(a), contextlib.closing(b):
        for c1, l1 in a:
            c2, l2 = next(b, (c1[:0], l1[:0]))
            n = min(len(l1), len(l2))
            if n:
                codes = np.empty((2 * n, c1.shape[1]), np.uint8)
                codes[0::2], codes[1::2] = c1[:n], c2[:n]
                lens = np.empty(2 * n, np.int32)
                lens[0::2], lens[1::2] = l1[:n], l2[:n]
                yield codes, lens
            if len(l2) < len(l1):
                raise ValueError("paired files have unequal read counts")


def _rebatch(blocks, batch_size: int, width: int):
    """(batch_size, width) batches filled from row blocks across block
    ends, the last one padded as the Python loop pads it (codes 4,
    length 0).  A batch that one block holds whole is yielded as a view
    of it, uncopied."""
    fill = 0
    for codes, lens in blocks:
        i, n = 0, len(lens)
        while i < n:
            if not fill and n - i >= batch_size:
                yield codes[i: i + batch_size], lens[i: i + batch_size]
                i += batch_size
                continue
            if not fill:
                buf = np.empty((batch_size, width), np.uint8)
                blens = np.empty(batch_size, np.int32)
            take = min(batch_size - fill, n - i)
            buf[fill: fill + take] = codes[i: i + take]
            blens[fill: fill + take] = lens[i: i + take]
            fill += take
            i += take
            if fill == batch_size:
                yield buf, blens
                fill = 0
    if fill:
        buf[fill:] = 4
        blens[fill:] = 0
        yield buf, blens


def write_fasta(path: str, records: Sequence[Tuple[str, str]],
                width: int = 100) -> None:
    with open(path, "w") as fh:
        for header, seq in records:
            fh.write(f">{header}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i: i + width] + "\n")
