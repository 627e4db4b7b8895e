"""The host parts behind -F/-f/-r/-R/-S of the PyTorch port against the
JAX package's, on random inputs made with numpy: ``collect_gap_reads``
(the port groups reads by contig once; each gap must get the same reads
in the same order), the ``-f`` writers (numpy in the port, per-record
loops in the JAX package), ``read_scaf_gap``, and the read tables
(``record_membership``, ``reads_on_scaffolds``, ``rpkm_table``).
Integer, string and byte results: tolerance 0; RPKM values are float64
in both and compared exactly."""

import gzip

import numpy as np
import pytest

from soapdenovo_trans_tpu.io import stagefiles as jsf
from soapdenovo_trans_tpu.stages import scaff as jscaff
from soapdenovo_trans_tpu_torch.io import stagefiles as tsf
from soapdenovo_trans_tpu_torch.stages import scaff as tscaff


def _placements(rng, n_reads, n_ctg):
    twin = np.arange(n_ctg) ^ 1
    full_len = np.repeat(rng.integers(150, 900, n_ctg // 2), 2)
    read_ctg = rng.integers(-1, n_ctg, n_reads).astype(np.int32)
    read_pos = rng.integers(-20, 900, n_reads).astype(np.int32)
    read_ins = np.where(np.arange(n_reads) < n_reads // 2, 300,
                        0).astype(np.int32)
    return twin, full_len, read_ctg, read_pos, read_ins


def _batches(rng, n_reads, batch, width=40):
    """A read stream in padded batches, a few length-0 rows inside."""
    codes = rng.integers(0, 5, (n_reads, width)).astype(np.uint8)
    lens = rng.integers(25, width + 1, n_reads).astype(np.int32)

    def factory():
        for lo in range(0, n_reads, batch):
            c, l = codes[lo:lo + batch], lens[lo:lo + batch]
            pad = batch - c.shape[0]
            yield (np.concatenate([c, np.full((pad, width), 4, np.uint8)]),
                   np.concatenate([l, np.zeros(pad, np.int32)]), 0)
    return factory


@pytest.mark.parametrize("seed,with_ins", [(0, True), (1, True), (2, False)])
def test_collect_gap_reads_matches_jax(seed, with_ins):
    rng = np.random.default_rng(seed)
    n_reads, n_ctg = 3000, 16
    twin, full_len, read_ctg, read_pos, read_ins = _placements(
        rng, n_reads, n_ctg)
    juncs = [(int(a), int(b), int(g)) for a, b, g in zip(
        rng.integers(0, n_ctg, 9), rng.integers(0, n_ctg, 9),
        rng.integers(-30, 200, 9))]
    ins = read_ins if with_ins else None
    want = jscaff.collect_gap_reads(
        juncs, read_ctg, read_pos, _batches(np.random.default_rng(9),
                                            n_reads, 700),
        twin, full_len, 300, 24, read_ins=ins)
    # another batch size for the port: the stream is the same
    got = tscaff.collect_gap_reads(
        juncs, read_ctg, read_pos, _batches(np.random.default_rng(9),
                                            n_reads, 256),
        twin, full_len, 300, 24, read_ins=ins)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert sum(map(len, got)) > 50
    for g_rows, w_rows in zip(got, want):
        for g, w in zip(g_rows, w_rows):
            assert g.dtype == np.uint8 and np.array_equal(g, w)


def test_collect_gap_reads_without_placed_reads():
    rng = np.random.default_rng(4)
    twin, full_len, _c, read_pos, _i = _placements(rng, 100, 4)
    got = tscaff.collect_gap_reads(
        [(0, 2, 10)], np.full(100, -1, np.int32), read_pos,
        _batches(rng, 100, 64), twin, full_len, 300, 24)
    assert got == [[]]


def _gap_rows(rng, n, width=50):
    codes = rng.integers(0, 5, (n, width)).astype(np.uint8)
    lens = rng.integers(1, width + 1, n)
    lens[:4] = (width, 1, 4, 8)
    return (rng.integers(1, 10**6, n), rng.integers(0, 500, n),
            rng.integers(-300, 3000, n), codes, lens)


def test_gap_read_writers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    readno, ctg0, pos, codes, lens = _gap_rows(rng, 300)
    rows = [(int(r), int(c), int(p), codes[i, :lens[i]])
            for i, (r, c, p) in enumerate(zip(readno, ctg0, pos))]
    # the port gathers its rows batch by batch, of unequal widths
    parts = [tsf.GapReads(readno[:100], ctg0[:100], pos[:100],
                          codes[:100, :50], lens[:100]),
             tsf.GapReads(readno[100:], ctg0[100:], pos[100:],
                          codes[100:], lens[100:])]
    reads = tsf.GapReads.concat(parts, 50)
    assert len(reads) == 300
    jsf.write_read_in_gap(str(tmp_path / "j.readInGap"), rows)
    tsf.write_read_in_gap(str(tmp_path / "t.readInGap"), reads)
    assert (tmp_path / "t.readInGap").read_bytes() == \
        (tmp_path / "j.readInGap").read_bytes()
    jsf.write_short_read_in_gap(str(tmp_path / "j.gz"),
                                [(r, c) for r, _c, _p, c in rows])
    tsf.write_short_read_in_gap(str(tmp_path / "t.gz"), reads)
    pe = rng.integers(0, 10**6, (200, 5))
    jsf.write_pe_read_on_contig(str(tmp_path / "jpe.gz"), pe)
    tsf.write_pe_read_on_contig(str(tmp_path / "tpe.gz"), pe)
    for name in ("", "pe"):
        with gzip.open(tmp_path / f"t{name}.gz") as got, \
                gzip.open(tmp_path / f"j{name}.gz") as want:
            assert got.read() == want.read() != b""


def test_gap_read_writers_take_no_rows(tmp_path):
    empty = tsf.GapReads.concat([], 50)
    tsf.write_read_in_gap(str(tmp_path / "e.readInGap"), empty)
    tsf.write_short_read_in_gap(str(tmp_path / "e.gz"), empty)
    tsf.write_pe_read_on_contig(str(tmp_path / "epe.gz"),
                                np.zeros((0, 5), np.int64))
    assert (tmp_path / "e.readInGap").read_bytes() == b""
    for name in ("e.gz", "epe.gz"):
        with gzip.open(tmp_path / name) as fh:
            assert fh.read() == b""


def _transcripts(rng, mod, n_ctg):
    out = []
    for locus in range(6):
        for index in range(int(rng.integers(1, 3))):
            contigs = rng.choice(n_ctg, int(rng.integers(1, 5)),
                                 replace=False).tolist()
            out.append(mod.Transcript(
                locus, index, "LINEAR", contigs,
                rng.integers(-20, 60, len(contigs) - 1).tolist()))
    return out


def test_read_scaf_gap_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    n_ctg, k = 30, 23
    twin = np.arange(n_ctg) ^ 1
    length_ex = np.repeat(rng.integers(80, 400, n_ctg // 2), 2)
    trs = _transcripts(np.random.default_rng(7), tscaff, n_ctg)
    recs = [(f"scaffold{i + 1}", "A") for i in range(len(trs))]
    routes = {0: [3, 4], 2: [9]}
    tsf.write_scaf_files(str(tmp_path / "x"), trs, recs, length_ex, twin, k,
                         routes=routes)
    want = jsf.read_scaf_gap(str(tmp_path / "x.scaf_gap"), length_ex, k)
    got = tsf.read_scaf_gap(str(tmp_path / "x.scaf_gap"), length_ex, k)
    assert len(got) == len(trs)
    for g, w, t in zip(got, want, trs):
        assert (g.locus, g.index, g.kind, g.contigs, g.gaps) == \
            (w.locus, w.index, w.kind, w.contigs, w.gaps) == \
            (t.locus, t.index, t.kind, t.contigs, t.gaps)


def test_read_tables_match_jax():
    rng = np.random.default_rng(8)
    n_ctg = 40
    twin = np.arange(n_ctg) ^ 1
    j_trs = _transcripts(np.random.default_rng(7), jscaff, n_ctg)
    t_trs = _transcripts(np.random.default_rng(7), tscaff, n_ctg)
    used = {c for tr in t_trs for c in tr.contigs}
    recs = [(f"scaffold{i + 1} 2 300 Locus_{tr.locus}_{tr.index} LINEAR",
             "ACGT" * int(rng.integers(20, 200)))
            for i, tr in enumerate(t_trs)]
    recs += [(f"C{c}", "AC" * int(rng.integers(50, 90)))
             for c in range(0, n_ctg, 2)
             if c not in used and c + 1 not in used]
    want_owner = jscaff.record_membership(recs, j_trs, twin, n_ctg)
    owner = tscaff.record_membership(recs, t_trs, twin, n_ctg)
    assert owner == want_owner and len(owner) > len(used)

    read_ctg = rng.integers(-1, n_ctg + 6, 5000).astype(np.int32)
    want_rec, want_hits = jscaff.reads_on_scaffolds(
        read_ctg, None, want_owner, len(recs))
    rec_of, hits = tscaff.reads_on_scaffolds(read_ctg, owner, len(recs))
    np.testing.assert_array_equal(rec_of, want_rec)
    np.testing.assert_array_equal(hits, want_hits)
    assert hits.dtype == np.int64 and hits.sum() > 0
    want_table = jscaff.rpkm_table(recs, want_hits)
    table = tscaff.rpkm_table(recs, hits)
    assert table == want_table
    assert [f"{r[3]:f}" for r in table] == [f"{r[3]:f}" for r in want_table]
    assert tscaff.rpkm_table(recs, np.zeros_like(hits))[0][3] == 0.0
