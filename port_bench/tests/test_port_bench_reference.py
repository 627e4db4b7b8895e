"""The reference on a tiny hand-made fixture, K = 5, with known
answers; and its controls on a small assembly of the port on the CPU."""

import collections
import gzip
import os

import numpy as np
import pytest
import torch

from port_bench import reference as ref

K = 5
CPU = torch.device("cpu")
CODE = {c: i for i, c in enumerate("ACGT")}


def _codes(*seqs):
    return np.array([[CODE[c] for c in s] for s in seqs], np.int8)


def _canon(s):
    return min(s, ref.revcomp(s.encode()).decode())


def test_kmer_values_are_canonical_and_skip_non_bases():
    codes = torch.tensor([0, 1, 2, 3, 0, 4, 1, 1], dtype=torch.int64)
    vals, ok = ref.kmer_values(codes, 3)
    assert ok.tolist() == [True, True, True, False, False, False]
    # ACG and its reverse complement CGT: ACG is smaller
    assert vals[0] == (0 << 4) | (1 << 2) | 2
    # CGT -> reverse complement ACG
    assert vals[1] == vals[0]


def test_histogram_counts_canonical_kmers_of_every_read():
    reads = ["ACGTTGCA", "TGCAACGT", "GGGGGGAA", "AAAAACCC"]
    km = ref.ReadKmers(_codes(*reads), K, CPU)
    want = collections.Counter(_canon(r[i:i + K]) for r in reads
                               for i in range(len(r) - K + 1))
    hist = km.histogram()
    assert hist.shape == (255,)
    for f in range(1, 6):
        assert hist[f - 1] == sum(1 for c in want.values() if c == f)
    assert km.keys.shape[0] == len(want)
    big = ref.ReadKmers(_codes(*["ACGTA"] * 300), K, CPU).histogram()
    assert big[254] == 1 and big.sum() == 1  # counts >= 255 in the last


def _write(prefix, name, text, opener=open):
    with opener(prefix + name, "wt") as fh:
        fh.write(text)


def _word(s):
    v = 0
    for c in s:
        v = (v << 2) | {"A": 0, "C": 1, "T": 2, "G": 3}[c]
    return f"{v:x}"


@pytest.fixture()
def fixture(tmp_path):
    """Reads of one sequence with a junction, and stage files written by
    hand for them: two edges meeting at the vertex K-mer TTTTC (the
    sequence's eight canonical K-mers are distinct)."""
    seq = "CAGATTTTCATA"
    reads = _codes(seq, ref.revcomp(seq.encode()).decode(), seq)
    prefix = os.path.join(tmp_path, "out")
    km = ref.ReadKmers(reads, K, CPU)
    _write(prefix, ".kmerFreq", "".join(f"{x}\n" for x in km.histogram()))
    e1, e2 = seq[:9], seq[4:]   # CAGATTTTC, TTTTCATA
    _write(prefix, ".edge.gz",
           f">length {len(e1) - K},{_word(e1[:K])},{_word(e1[-K:])},"
           f"cvg 10, 1\n{e1[K:]}\n"
           f">length {len(e2) - K},{_word(e2[:K])},{_word(e2[-K:])},"
           f"cvg 10, 1\n{e2[K:]}\n", gzip.open)
    _write(prefix, ".preArc", "1 3 2\n4 2 2\n")
    _write(prefix, ".contig", f">1 length {len(seq)} cvg_1.0_tip_0\n{seq}\n")
    _write(prefix, ".ContigIndex",
           f"Edge_num 2 2\nindex\tlength\treverseComplement\n1\t{len(seq)}"
           "\t1\n")
    _write(prefix, ".readOnContig",
           "read\tcontig\tpos\n1\t1\t0\t+\n2\t2\t0\t-\n3\t1\t0\t+\n")
    _write(prefix, ".scafSeq", f">C0\n{seq}\n")
    _write(prefix, ".contigPosInscaff", "")
    return prefix, reads


def test_known_answers_on_the_fixture(fixture):
    prefix, reads = fixture
    out = ref.check(prefix, reads, K, CPU)
    assert out == {name: 0 for name in ref.LIMITS}


def test_each_broken_file_is_caught(fixture):
    prefix, reads = fixture
    _write(prefix, ".kmerFreq", "9\n" * 255)
    _write(prefix, ".preArc", "1 2 1\n")        # no walk joins 1 to 2
    _write(prefix, ".readOnContig", "read\tcontig\tpos\n1\t1\t3\t+\n")
    _write(prefix, ".scafSeq", ">C0\nCAGATTTTCATT\n")
    out = ref.check(prefix, reads, K, CPU)
    assert out["kmerfreq_bins_off"] > 0
    assert out["arcs_unjoined"] == 1 and out["arcs_missing"] == 2
    assert out["placements_off"] == 1 and out["reads_unplaced"] == 2
    assert out["transcript_pieces_off"] == 1
    _write(prefix, ".contig", ">1 length 12 cvg_1.0_tip_0\nCAGATTGTCATA\n")
    assert ref.check(prefix, reads, K, CPU)["contig_kmers_unread"] > 0


def test_output_left_out_is_counted(tmp_path):
    """A 120-bp contig read at every tenth base, eight times over: each
    of its K-mers is solid and each read is due a placement."""
    k = 9
    rng = np.random.default_rng(3)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    reads = _codes(*[seq[o:o + 30] for o in range(0, 91, 10)] * 8)
    km = ref.ReadKmers(reads, k, CPU)
    assert int(km.count.min()) >= ref.SOLID
    n = km.keys.shape[0]
    assert ref.kmers_missing(km, [seq.encode()], k, CPU) == (0, n)
    half = ref.kmers_missing(km, [seq[:60].encode()], k, CPU)
    assert half == (n - (60 - k + 1), n)
    printed = {1: seq.encode()}
    every = np.array([[r + 1, 1, 0, 1] for r in range(reads.shape[0])])
    assert ref.reads_unplaced(reads, printed, every, k, CPU) == 0
    assert ref.reads_unplaced(reads, printed, every[::2], k, CPU) == \
        reads.shape[0] // 2
    # a read of the second half's windows only: not due on a 60-bp contig
    assert ref.reads_unplaced(reads, {1: seq[:60].encode()},
                              every[:0], k, CPU) == 8 * 4
    prefix = os.path.join(tmp_path, "out")
    _write(prefix, ".scafSeq", f">C0\n{seq}\n")
    _write(prefix, ".contigPosInscaff", "")
    assert ref.contigs_unscaffolded(prefix, printed, {1: 2}) == 0
    _write(prefix, ".scafSeq", f">scaffold1 1 120\n{seq}\n")
    _write(prefix, ".contigPosInscaff", ">scaffold1\n2\t0\t-\t120\n")
    assert ref.contigs_unscaffolded(prefix, printed, {1: 2}) == 0
    _write(prefix, ".contigPosInscaff", "")
    assert ref.contigs_unscaffolded(prefix, printed, {1: 2}) == 1
    assert ref.contigs_unscaffolded(prefix, {1: seq[:99].encode()},
                                    {1: 2}) == 0


def test_pair_keys_are_strand_free():
    s = "ACGTTGCAGT"
    fw = torch.tensor([CODE[c] for c in s], dtype=torch.int64)
    rc = torch.tensor([CODE[c] for c in ref.revcomp(s.encode()).decode()],
                      dtype=torch.int64)
    a, b = ref.pair_keys(fw, 3), ref.pair_keys(rc, 3)
    assert sorted(a.tolist()) == sorted(b.tolist())


def test_controls_fail_the_check_on_a_small_assembly(tmp_path):
    from port_bench import control

    got = {r["reading"]: r for r in control.readings(
        "pe100_k23_m0.uniform", 21, None, True, device_name="cpu",
        pairs=2500, transcripts=25, workroot=str(tmp_path))}
    assert all(got["program"][n] <= ref.LIMITS[n] for n in ref.LIMITS)
    for ctl in control.CONTROLS:
        assert any(got[ctl.__name__][n] > ref.LIMITS[n]
                   for n in ref.LIMITS), ctl.__name__
    for ctl, n in control.DROPS.items():
        assert got[ctl][n] > ref.LIMITS[n], ctl
