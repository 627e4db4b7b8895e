"""Library .config parser.

A copy of ``soapdenovo_trans_tpu/io/libconfig.py``: the port loads no
module of the JAX package, so a run of the port stands on its own
where only torch is installed.

Parity with scan_libInfo (reference src/lib.c:118-439) and the format
documented in reference README.md:117-147: a global ``max_rd_len``
plus ``[LIB]`` sections carrying insert-size / orientation / usage
metadata and read-file lists.  Libraries are sorted by ascending
``avg_ins`` like the reference (cmp_lib, src/lib.c:97).
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class LibInfo:
    """One [LIB] section (reference LIB_INFO, src/inc/def.h)."""

    avg_ins: int = 0
    reverse_seq: int = 0       # 1: reverse-complement reads on input
    asm_flags: int = 3         # &1: used for contigs, &2: used for scaffolds
    rd_len_cutoff: int = 0     # truncate reads longer than this (0 = off)
    map_len: int = 0           # min aligned length for a reliable placement
    pair_num_cut: int = 0
    rank: int = 0
    # read files; a1/a2 and q1/q2 pair by file position, p interleaves
    f1: List[str] = dataclasses.field(default_factory=list)
    f2: List[str] = dataclasses.field(default_factory=list)
    q1: List[str] = dataclasses.field(default_factory=list)
    q2: List[str] = dataclasses.field(default_factory=list)
    f: List[str] = dataclasses.field(default_factory=list)
    q: List[str] = dataclasses.field(default_factory=list)
    p: List[str] = dataclasses.field(default_factory=list)
    b: List[str] = dataclasses.field(default_factory=list)  # BAM

    @property
    def has_pairs(self) -> bool:
        return bool(self.f1 or self.q1 or self.p or self.b)


@dataclasses.dataclass
class Config:
    max_rd_len: int
    libs: List[LibInfo]


_INT_KEYS = {
    "avg_ins": "avg_ins",
    "reverse_seq": "reverse_seq",
    "asm_flags": "asm_flags",
    "asm_flag": "asm_flags",
    "rd_len_cutof": "rd_len_cutoff",
    "rd_len_cutoff": "rd_len_cutoff",
    "map_len": "map_len",
    "pair_num_cutoff": "pair_num_cut",
    "pair_num_cut": "pair_num_cut",
    "rank": "rank",
}
_FILE_KEYS = ("f1", "f2", "q1", "q2", "f", "q", "p", "b")


def parse_config(path: str) -> Config:
    max_rd_len = 0
    libs: List[LibInfo] = []
    cur: LibInfo | None = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#") or line.startswith(";"):
                continue
            if line.upper().startswith("[LIB]"):
                cur = LibInfo()
                libs.append(cur)
                continue
            if "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if key == "max_rd_len":
                max_rd_len = int(val)
                continue
            if cur is None:
                continue
            if key in _INT_KEYS:
                setattr(cur, _INT_KEYS[key], int(val))
            elif key in _FILE_KEYS:
                getattr(cur, key).append(val)
    for lib in libs:
        if len(lib.f1) != len(lib.f2) or len(lib.q1) != len(lib.q2):
            raise ValueError(
                "paired file lists must have equal lengths (f1/f2, q1/q2)")
    libs.sort(key=lambda l: l.avg_ins)
    return Config(max_rd_len=max_rd_len, libs=libs)
