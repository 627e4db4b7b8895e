"""Minimal pure-Python BAM reader (reference: bundled samtools
libbam.a via read1seqbam, src/readseq1by1.c:416-556).

A copy of ``soapdenovo_trans_tpu/io/bam.py``: the port loads no module
of the JAX package, so a run of the port stands on its own where only
torch is installed.

BAM is BGZF-compressed (concatenated gzip members — Python's gzip
module handles those natively) around a simple binary record layout;
only read sequences in file order are needed, so no index/random access.

QC-fail (0x200) reads are dropped, as are secondary (0x100),
supplementary (0x800) and duplicate (0x400) alignments; reverse-strand
records (0x10) are reverse-complemented back to the original read
orientation so assembly sees the as-sequenced read.
"""

from __future__ import annotations

import gzip
import struct
from typing import Iterator

_SEQ_NT = "=ACMGRSVTWYHKDBN"  # 4-bit code -> base
_COMP = str.maketrans("ACGTN", "TGCAN")

SKIP_FLAGS = 0x100 | 0x200 | 0x400 | 0x800


def read_bam(path: str) -> Iterator[str]:
    with gzip.open(path, "rb") as fh:
        magic = fh.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file (magic {magic!r})")
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            fh.read(l_name + 4)
        while True:
            raw = fh.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            rec = fh.read(block_size)
            if len(rec) < block_size:
                return
            (_refid, _pos, l_read_name, _mapq, _bin, n_cigar, flag,
             l_seq, _nref2, _npos, _tlen) = struct.unpack_from(
                "<iiBBHHHiiii", rec, 0)
            if flag & SKIP_FLAGS:
                continue
            off = 32 + l_read_name + 4 * n_cigar
            nbytes = (l_seq + 1) // 2
            seq4 = rec[off : off + nbytes]
            chars = []
            for i in range(l_seq):
                code = seq4[i >> 1] >> (4 if i % 2 == 0 else 0) & 0xF
                ch = _SEQ_NT[code]
                chars.append(ch if ch in "ACGT" else "N")
            s = "".join(chars)
            if flag & 0x10:  # mapped to reverse strand
                s = s.translate(_COMP)[::-1]
            yield s
