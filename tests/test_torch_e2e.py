"""The JAX end-to-end suite (tests/test_e2e.py) on the port: reads
simulated from known transcripts go through the port's CLI (``all``, and
for the gap-fill fixture ``scaff -S`` after it), at K = 21 (K = 23 with
``-F -f -L 100`` for the gap-fill fixture).  For each of the six
fixtures:

(a) the port on the CPU recovers the transcripts, by the JAX suite's own
    assertions;
(b) the JAX CLI on the same config writes the same files, byte for byte
    (``.gz`` files decompressed, the output prefix replaced, since
    ``.scafStatistics`` names its own path); tolerance 0;
(c) the port on a mesh of two CPU shards (``SOAPDENOVO_TORCH_DEVICE=
    cpu,cpu``) writes the files of (a).

The fixture functions below are copies of the JAX suite's and use the port's
``ops/bits`` and ``io/fastx``; every fixture is made from its own numpy
seed.  The file imports neither jax nor the JAX package at module level
(the JAX CLI is imported inside ``run_jax_cli``), so that
``chip_smoke.py`` can load it by path on a machine without jax and run
the same fixtures on the card.
"""

from __future__ import annotations

import gzip
import os
import time
from typing import Callable, List, NamedTuple

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.io import fastx
from soapdenovo_trans_tpu_torch.ops import bits


class Fixture(NamedTuple):
    cfg: str
    k: int
    flags: List[str]          # extra flags of ``all``
    resume: List[str]         # a second CLI call on the prefix, or []
    check: Callable           # check(prefix, .scafSeq texts after each call)


def unique_kmer_seq(rng, n, k):
    while True:
        s = "".join(rng.choice(list("ACGT"), size=n))
        cans = set()
        ok = True
        for j in range(n - k + 1):
            win = s[j : j + k]
            can = min(win, bits.revcomp_str(win))
            if can in cans:
                ok = False
                break
            cans.add(can)
        if ok:
            return s


def simulate_reads(rng, transcript, read_len=50, coverage=20,
                   error_rate=0.0):
    n_reads = int(len(transcript) * coverage / read_len)
    # guarantee terminal kmers are sampled, error-free (the assembler
    # can only build what the reads contain)
    reads = [transcript[:read_len] for _ in range(3)] + \
            [transcript[-read_len:] for _ in range(3)]
    for _ in range(n_reads):
        start = int(rng.integers(0, len(transcript) - read_len + 1))
        r = transcript[start : start + read_len]
        if error_rate > 0:
            chars = list(r)
            for i in range(len(chars)):
                if rng.random() < error_rate:
                    chars[i] = "ACGT"[int(rng.integers(4))]
            r = "".join(chars)
        if rng.random() < 0.5:
            r = bits.revcomp_str(r)
        reads.append(r)
    return reads


def write_inputs(folder, reads, read_len):
    fa = os.path.join(folder, "reads.fa")
    fastx.write_fasta(fa, [(f"read{i}", r) for i, r in enumerate(reads)])
    cfg = os.path.join(folder, "reads.config")
    with open(cfg, "w") as fh:
        fh.write(f"max_rd_len={read_len}\n[LIB]\nasm_flags=3\nf={fa}\n")
    return cfg


def read_contig_fasta(path):
    seqs, cur = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            elif line:
                cur.append(line)
    if cur:
        seqs.append("".join(cur))
    return seqs


def canon(s):
    return min(s, bits.revcomp_str(s))


def single_error_free(folder, rng):
    t = unique_kmer_seq(rng, 400, 21)
    reads = simulate_reads(rng, t, read_len=50, coverage=25)

    def check(out, _scafs):
        contigs = read_contig_fasta(out + ".contig")
        assert canon(t) in {canon(c) for c in contigs}

    return Fixture(write_inputs(folder, reads, 50), 21, [], [], check)


def single_with_errors(folder, rng):
    t = unique_kmer_seq(rng, 400, 21)
    reads = simulate_reads(rng, t, read_len=50, coverage=40,
                           error_rate=0.005)

    def check(out, _scafs):
        contigs = read_contig_fasta(out + ".contig")
        # error kmers must be cleaned away; the true transcript contig
        # must survive intact
        cc = {canon(c) for c in contigs}
        assert canon(t) in cc, f"lengths found: {[len(c) for c in contigs]}"

    return Fixture(write_inputs(folder, reads, 50), 21, [], [], check)


def two_isoforms_shared_exon(folder, rng):
    # two transcripts sharing a middle exon; assembler should produce
    # contigs covering all three segments
    e1 = unique_kmer_seq(rng, 150, 21)
    shared = unique_kmer_seq(rng, 120, 21)
    e3 = unique_kmer_seq(rng, 150, 21)
    t1 = e1 + shared
    t2 = shared + e3
    reads = (simulate_reads(rng, t1, 50, 20) +
             simulate_reads(rng, t2, 50, 20))

    def check(out, _scafs):
        contigs = read_contig_fasta(out + ".contig")
        # every true segment must be findable in some contig
        for seg in (e1[: 150 - 21], shared, e3[21:]):
            found = any(seg in c or bits.revcomp_str(seg) in c
                        for c in contigs)
            assert found, (len(seg), [len(c) for c in contigs])

    return Fixture(write_inputs(folder, reads, 50), 21, [], [], check)


def pe_scaffolding(folder, rng):
    """A paired-end library: repeat-split transcripts must come back
    joined in .scafSeq."""
    u1 = unique_kmer_seq(rng, 150, 21)
    u2 = unique_kmer_seq(rng, 150, 21)
    u3 = unique_kmer_seq(rng, 150, 21)
    u4 = unique_kmer_seq(rng, 150, 21)
    rep = unique_kmer_seq(rng, 45, 21)
    t1, t2 = u1 + rep + u2, u3 + rep + u4
    ins, rl = 140, 45
    pairs = []
    for t in (t1, t2):
        for _ in range(60):
            start = int(rng.integers(0, len(t) - ins + 1))
            frag = t[start : start + ins]
            pairs.append(frag[:rl])
            pairs.append(bits.revcomp_str(frag[-rl:]))
    singles = []
    for t in (t1, t2):
        singles += [t[i : i + 50] for i in range(0, len(t) - 50 + 1, 4)]
        singles += [t[:50]] * 2 + [t[-50:]] * 2

    p_fa = os.path.join(folder, "pairs.fa")
    s_fa = os.path.join(folder, "singles.fa")
    fastx.write_fasta(p_fa, [(f"p{i}", r) for i, r in enumerate(pairs)])
    fastx.write_fasta(s_fa, [(f"s{i}", r) for i, r in enumerate(singles)])
    cfg = os.path.join(folder, "pe.config")
    with open(cfg, "w") as fh:
        fh.write("max_rd_len=50\n"
                 "[LIB]\navg_ins=140\nasm_flags=3\nmap_len=32\n"
                 f"p={p_fa}\n"
                 "[LIB]\nasm_flags=1\n"
                 f"f={s_fa}\n")

    def check(out, _scafs):
        scafs = read_contig_fasta(out + ".scafSeq")
        assert scafs, "no scaffold output"

        def joined(a, b):
            for s in scafs:
                for cand in (s, bits.revcomp_str(s)):
                    ia, ib = cand.find(a[40:100]), cand.find(b[40:100])
                    if 0 <= ia < ib:
                        return True
            return False

        assert joined(u1, u2)
        assert joined(u3, u4)

    return Fixture(cfg, 21, [], [], check)


def rpkm_output(folder, rng):
    """-R produces .readOnScaf and .RPKM.Stat with sane proportions."""
    t_long = unique_kmer_seq(rng, 500, 21)
    t_short = unique_kmer_seq(rng, 250, 21)
    reads = (simulate_reads(rng, t_long, 50, 30) +
             simulate_reads(rng, t_short, 50, 30))

    def check(out, _scafs):
        assert os.path.exists(out + ".RPKM.Stat")
        rows = []
        for line in open(out + ".RPKM.Stat"):
            if line.startswith(("#", "Transcript_ID")):
                continue
            name, ln, hits, rpkm = line.split("\t")
            rows.append((name, int(ln), int(hits), float(rpkm)))
        assert rows, "empty RPKM table"
        # both transcripts present with nonzero hit counts
        withhits = [r for r in rows if r[2] > 0]
        assert len(withhits) >= 2
        assert os.path.exists(out + ".readOnScaf")
        assert sum(1 for _ in open(out + ".readOnScaf")) > 0

    return Fixture(write_inputs(folder, reads, 50), 21, ["-R"], [], check)


def gap_fill(folder, rng):
    """-F local gap assembly: a coverage hole in the contig-building
    library is reconstructed exactly from the mapping-only PE library;
    -f gap-read export, the stage files, and the -S structure resume."""
    t1 = "".join(rng.choice(list("ACGT"), size=700))
    hole = (330, 370)
    ins, rl = 200, 50
    cov = [t1[i : i + rl] for i in range(0, len(t1) - rl + 1, 2)
           if i + rl <= hole[0] or i >= hole[1]]
    pe = []
    for i in range(0, len(t1) - ins, 4):
        frag = t1[i : i + ins]
        pe.append(frag[:rl])
        pe.append(bits.revcomp_str(frag[-rl:]))
    c_fa = os.path.join(folder, "cov.fa")
    p_fa = os.path.join(folder, "pe.fa")
    fastx.write_fasta(c_fa, [(f"c{i}", r) for i, r in enumerate(cov)])
    fastx.write_fasta(p_fa, [(f"p{i}", r) for i, r in enumerate(pe)])
    cfg = os.path.join(folder, "lib.config")
    with open(cfg, "w") as fh:
        fh.write("max_rd_len=50\n"
                 f"[LIB]\navg_ins=0\nasm_flags=1\nf={c_fa}\n"
                 f"[LIB]\navg_ins=200\nasm_flags=2\np={p_fa}\n")

    def check(out, scaf_texts):
        # the scaffold must reconstruct t1 (no Ns) across the hole
        scafs = read_contig_fasta(out + ".scafSeq")
        core = t1[5:-5]
        assert any(core in s or core in bits.revcomp_str(s)
                   for s in scafs), [len(s) for s in scafs]
        # filled gap recorded
        gap_lines = open(out + ".gapSeq").read()
        assert "localasm" in gap_lines or "overlap" in gap_lines
        # stage-file surface
        assert open(out + ".peGrads").readline().startswith("grads&num:")
        assert os.path.getsize(out + ".ctg2Read") > 0
        for ext in (".links", ".readInGap", ".shortreadInGap.gz",
                    ".PEreadOnContig.gz"):
            assert os.path.exists(out + ext), ext
        # -S resume: the sequences rebuilt from .scaf_gap are the same
        assert len(scaf_texts) == 2 and scaf_texts[1] == scaf_texts[0]

    return Fixture(cfg, 23, ["-F", "-f", "-L", "100"],
                   ["scaff", "-s", cfg, "-F", "-L", "100", "-S"], check)


# name -> (function writing the inputs, numpy seed)
FIXTURES = {"single_error_free": (single_error_free, 0),
            "single_with_errors": (single_with_errors, 1),
            "two_isoforms_shared_exon": (two_isoforms_shared_exon, 2),
            "pe_scaffolding": (pe_scaffolding, 3),
            "rpkm_output": (rpkm_output, 4),
            "gap_fill": (gap_fill, 5)}


def build(name: str, folder: str) -> Fixture:
    """Write the inputs of fixture ``name`` into ``folder``."""
    make, seed = FIXTURES[name]
    return make(folder, np.random.default_rng(seed))


def run(cli, fx: Fixture, out: str):
    """The fixture's CLI calls through ``cli.main`` on prefix ``out``
    (its folder is made); returns their results, the .scafSeq text after
    each call and each call's seconds."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    calls = [["all", "-s", fx.cfg, "-o", out, "-K", str(fx.k), *fx.flags]]
    if fx.resume:
        calls.append([*fx.resume, "-g", out])
    results, scafs, seconds = [], [], []
    for argv in calls:
        t0 = time.time()
        results.append(cli.main(argv))
        seconds.append(time.time() - t0)
        with open(out + ".scafSeq") as fh:
            scafs.append(fh.read())
    return results, scafs, seconds


def output_files(out: str) -> dict:
    """{extension: bytes} of every file in the folder of prefix ``out``
    (which holds that run's outputs alone): ``.gz`` files decompressed,
    the prefix replaced by ``<prefix>``."""
    folder, name = os.path.split(out)
    files = {}
    for f in sorted(os.listdir(folder)):
        assert f.startswith(name + "."), f
        opener = gzip.open if f.endswith(".gz") else open
        with opener(os.path.join(folder, f), "rb") as fh:
            files[f[len(name):]] = fh.read().replace(out.encode(),
                                                     b"<prefix>")
    return files


def assert_same_outputs(want: str, got: str) -> int:
    """The runs of prefixes ``want`` and ``got`` wrote the same files;
    returns how many."""
    a, b = output_files(want), output_files(got)
    assert sorted(b) == sorted(a)
    differ = [ext for ext in a if a[ext] != b[ext]]
    assert not differ, differ
    return len(a)


def run_jax_cli(fx: Fixture, out: str):
    from soapdenovo_trans_tpu import cli as jcli
    from soapdenovo_trans_tpu.ops import dictionary as jd

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "CAP_MODE", jd.CAP_MODE)  # cli.main mutates it
        return run(jcli, fx, out)


NAMES = list(FIXTURES)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_cpu(tmp_path_factory):
    """name -> (fixture, prefix, .scafSeq texts) of the port's run on
    the CPU, made once a module."""
    runs = {}

    def get(name):
        if name not in runs:
            folder = str(tmp_path_factory.mktemp(name))
            fx = build(name, folder)
            out = os.path.join(folder, "port", "asm")
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
                _results, scafs, _seconds = run(tcli, fx, out)
            runs[name] = fx, out, scafs
        return runs[name]

    return get


@pytest.mark.parametrize("name", NAMES)
def test_port_recovers_transcripts(name, port_cpu):
    fx, out, scafs = port_cpu(name)
    fx.check(out, scafs)


@pytest.mark.parametrize("name", NAMES)
def test_port_files_equal_jax_cli(name, port_cpu):
    fx, out, _scafs = port_cpu(name)
    jax_out = os.path.join(os.path.dirname(os.path.dirname(out)), "jax",
                           "asm")
    run_jax_cli(fx, jax_out)
    assert assert_same_outputs(jax_out, out) >= 20


@pytest.mark.parametrize("name", NAMES)
def test_mesh_files_equal_one_device(name, port_cpu, monkeypatch):
    fx, out, _scafs = port_cpu(name)
    mesh_out = os.path.join(os.path.dirname(os.path.dirname(out)), "mesh",
                            "asm")
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu,cpu")
    results, _scafs, _seconds = run(tcli, fx, mesh_out)
    assert results[0].pregraph.exchanges is not None  # the mesh path ran
    assert assert_same_outputs(out, mesh_out) >= 20
