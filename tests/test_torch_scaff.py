"""Port parity of the scaff stage's host passes (stages/scaff.py,
stages/pelinks.py) and its writers and readers (io/stagefiles.py),
against the JAX package on the same numpy inputs: the transcript
structure on random and hand-made connection graphs (LINEAR, FORK,
BUBBLE and COMPLEX loci), deleteUnlikelyCnt, the heaviest-path
extraction, the placement tables (the JAX package writes and parses them
with pandas here) and the .scafStatistics report.  Exact comparison."""

import numpy as np
import pytest

from soapdenovo_trans_tpu.io import stagefiles as jfiles
from soapdenovo_trans_tpu.stages import pelinks as jpelinks
from soapdenovo_trans_tpu.stages import scaff as jscaff
from soapdenovo_trans_tpu_torch.io import fastx as tfastx
from soapdenovo_trans_tpu_torch.io import stagefiles as tfiles
from soapdenovo_trans_tpu_torch.stages import pelinks as tpelinks
from soapdenovo_trans_tpu_torch.stages import scaff as tscaff

K = 23


class Conn:
    """A host connection set, as run_scaff hands build_structure."""

    def __init__(self, f, t, gap, weight, se):
        self.from_ctg, self.to_ctg, self.gap = f, t, gap
        self.weight, self.se_count = weight, se
        self.n = f.shape[0]


def _twin_closed(f, t, gap, w, se, twin):
    """Each connection plus its twin (twin[t] -> twin[f])."""
    return Conn(np.concatenate([f, twin[t]]), np.concatenate([t, twin[f]]),
                np.concatenate([gap, gap]), np.concatenate([w, w]),
                np.concatenate([se, se]))


def random_graph(seed, n_ctg, n_conn, se_share):
    """tests/test_scaff.py's random twin-symmetric connections, with a
    share of single-read supports (which linearization keeps)."""
    rng = np.random.default_rng(seed)
    twin = np.arange(n_ctg, dtype=np.int64) ^ 1
    full_len = rng.integers(80, 400, n_ctg // 2).repeat(2)
    f = rng.integers(0, n_ctg, n_conn)
    t = rng.integers(0, n_ctg, n_conn)
    keep = (f != t) & (twin[f] != t)
    f, t = f[keep], t[keep]
    w = rng.integers(1, 12, f.shape[0])
    gap = rng.integers(-30, 150, f.shape[0])
    se = (rng.random(f.shape[0]) < se_share) * rng.integers(1, 4, f.shape[0])
    conn = _twin_closed(f, t, gap, w, se, twin)
    return conn, twin, full_len, full_len >= 100, rng.integers(1, 100, n_ctg)


def handmade_graph():
    """A bubble (0->2, 0->4, 2->6, 4->6), a fork (8->10, 8->12), a chain
    (14->16->18) and a chain through a non-unique contig (20->22->24)."""
    n_ctg = 26
    twin = np.arange(n_ctg, dtype=np.int64) ^ 1
    full_len = np.full(n_ctg, 300)
    full_len[22:24] = 60
    f = np.array([0, 0, 2, 4, 8, 8, 14, 16, 20, 22])
    t = np.array([2, 4, 6, 6, 10, 12, 16, 18, 22, 24])
    n = f.shape[0]
    conn = _twin_closed(f, t, np.full(n, 10), np.full(n, 5),
                        np.ones(n, np.int64), twin)
    return conn, twin, full_len, full_len >= 100, np.arange(n_ctg) % 7 + 1


def _key(transcripts):
    return [(tr.locus, tr.index, tr.kind, list(tr.contigs), list(tr.gaps))
            for tr in transcripts]


@pytest.mark.parametrize("graph,max_cnt,kinds", [
    ("handmade", 0, {"LINEAR", "FORK", "BUBBLE"}),
    ("random-77", 2, {"LINEAR", "FORK", "COMPLEX"}),
    ("random-77", 0, {"COMPLEX"}),
    ("random-5", 3, {"COMPLEX"}),
    ("random-3", 2, {"LINEAR"}),
])
def test_build_structure_matches_jax(graph, max_cnt, kinds):
    if graph == "handmade":
        args = handmade_graph()
    else:
        seed = int(graph.split("-")[1])
        args = random_graph(seed, *{77: (400, 300, 0.0), 5: (200, 400, 0.3),
                                    3: (1000, 500, 0.2)}[seed])
    want = jscaff.build_structure(*args, jscaff.ScaffParams(max_cnt=max_cnt),
                                  K)
    got = tscaff.build_structure(*args, tscaff.ScaffParams(max_cnt=max_cnt),
                                 K)
    assert _key(got) == _key(want)
    assert kinds <= {tr.kind for tr in got}


def _hub_graph(mod):
    """tests/test_scaff.py's mini graph: non-unique hub 0 linked to
    unique 1, 2, 3 with weights 9, 5, 2."""
    unique = np.array([False, True, True, True] + [True] * 4)
    conn = Conn(np.array([0, 0, 0]), np.array([1, 2, 3]), np.zeros(3),
                np.array([9, 5, 2]), np.zeros(3))
    return mod.ConnGraph(conn, np.arange(8), np.full(8, 200), unique)


@pytest.mark.parametrize("cut_off", [0, 1, 2, 3, 11])
def test_delete_unlikely_matches_jax(cut_off):
    live = []
    for mod in (jscaff, tscaff):
        g = _hub_graph(mod)
        mod.delete_unlikely(g, 4, cut_off)
        live.append(sorted(t for t, r in g.out[0].items()
                           if not r["deleted"]))
    assert live[0] == live[1]
    assert len(live[1]) == (3 if cut_off in (0, 3, 11) else cut_off)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unlikely_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_ctg = 40
    twin = np.arange(n_ctg, dtype=np.int64) ^ 1
    unique = rng.random(n_ctg) < 0.6
    f = rng.integers(0, n_ctg, 300)
    t = rng.integers(0, n_ctg, 300)
    wt = rng.integers(1, 9, 300)
    alive = rng.random(300) < 0.9
    for cut_off in (1, 2, 4):
        want = jscaff._unlikely_mask(f, t, wt, alive, unique, twin, n_ctg,
                                     cut_off)
        got = tscaff._unlikely_mask(f, t, wt, alive, unique, twin, n_ctg,
                                    cut_off)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_heaviest_paths_matches_jax(seed):
    """Random DAGs over a locus (edges from lower to higher rows, row 0
    included), with random coverage and -t."""
    rng = np.random.default_rng(seed)
    n = 12
    f, t = np.nonzero(np.triu(rng.random((n, n)) < 0.3, 1))
    conn = Conn(f, t, np.zeros(f.shape[0]), rng.integers(1, 9, f.shape[0]),
                np.zeros(f.shape[0]))
    cvg = rng.integers(1, 60, n).astype(float)
    locus = list(range(n))
    paths = []
    for mod in (jscaff, tscaff):
        g = mod.ConnGraph(conn, np.arange(n), np.full(n, 200),
                          np.ones(n, bool))
        paths.append(mod.heaviest_paths(
            g, locus, cvg, mod.ScaffParams(max_transcripts=3 + seed)))
    assert paths[1] == paths[0] and paths[1]


def test_heaviest_paths_keeps_row0():
    """Contig row 0 is a valid path head (tests/test_scaff.py)."""
    conn = Conn(np.array([0, 1]), np.array([1, 2]), np.zeros(2),
                np.array([5, 5]), np.zeros(2))
    cvg = np.array([10.0, 50.0, 10.0, 0, 0, 0])
    paths = []
    for mod in (jscaff, tscaff):
        g = mod.ConnGraph(conn, np.arange(6), np.full(6, 200),
                          np.ones(6, bool))
        paths.append(mod.heaviest_paths(g, [0, 1, 2], cvg,
                                        mod.ScaffParams()))
    assert paths[1] == paths[0] and [0, 1, 2] in paths[1]


def _table(rng, n):
    return (np.arange(1, n + 1), rng.integers(1, 5000, n),
            rng.integers(-150, 3000, n),
            np.where(rng.random(n) < 0.5, "+", "-"))


CHUNK = 64  # rows a chunk of the port's writer in these tests


def _wide_table(rng, n):
    """A placement table whose columns change width from chunk to
    chunk: read numbers from 1 up, contigs above 2^31 in every third
    chunk, pos 0, negative and up to 10^(chunk % 7) - 1."""
    chunk = np.arange(n) // CHUNK
    return (np.arange(1, n + 1),
            np.where(chunk % 3 == 2, rng.integers(2**31, 2**40, n),
                     rng.integers(1, 5000, n)),
            np.where(rng.random(n) < 0.1, 0, rng.integers(
                -150, 10 ** (chunk % 7 + 1), n) // 10),
            np.where(rng.random(n) < 0.5, "+", "-"))


@pytest.mark.parametrize(
    "n", [0, 1, 5000, CHUNK - 1, CHUNK, CHUNK + 1, 7 * CHUNK + 3])
def test_placement_table_matches_jax(n, tmp_path, monkeypatch):
    """Bytes of .readOnContig/.ctg2Read (the JAX package writes through
    pandas here) and the parsed columns (it parses through pandas), the
    port's writer in chunks of CHUNK rows: none, one, part of one, one
    whole, one and a row, many."""
    monkeypatch.setattr(tfiles, "_ROWS_PER_CHUNK", CHUNK)
    cols = _wide_table(np.random.default_rng(n), n)
    want = str(tmp_path / "j.readOnContig")
    got = str(tmp_path / "t.readOnContig")
    jfiles.write_placement_table(want, *cols)
    tfiles.write_placement_table(got, *cols)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    for a, b, c in zip(jpelinks._load_rows(want, True),
                       tpelinks._load_rows(got), cols):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)


@pytest.mark.parametrize("n", [0, CHUNK + 1, 5000])
def test_read_information_matches_jax(n, tmp_path, monkeypatch):
    """.readInformation (-r/-R): six columns, no header, the same bytes
    as the JAX package's writer, the port's in chunks of CHUNK rows."""
    monkeypatch.setattr(tfiles, "_ROWS_PER_CHUNK", CHUNK)
    rng = np.random.default_rng(n)
    readno, ctg, ctg_off, orien = _wide_table(rng, n)
    cols = (readno, rng.integers(-1, 150, n), ctg, ctg_off,
            rng.integers(23, 200, n), orien)
    want = str(tmp_path / "j.readInformation")
    got = str(tmp_path / "t.readInformation")
    jfiles.write_read_information(want, *cols)
    tfiles.write_read_information(got, *cols)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()


def test_placement_tables_need_no_pandas(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "pandas", None)
    cols = _table(np.random.default_rng(9), 300)
    path = str(tmp_path / "x.ctg2Read")
    tfiles.write_placement_table(path, *cols)
    for a, c in zip(tpelinks._load_rows(path), cols):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("genome_size", [0, 400, 100_000])
def test_scaf_statistics_match_jax(tmp_path, genome_size):
    """The .scafStatistics report of tests/test_scaff.py's records plus
    random ones: <100bp records excluded, singletons, N ladder, NG50."""
    rng = np.random.default_rng(genome_size)
    recs = [("scaffold1 2 300 Locus_0_0 LINEAR",
             "A" * 150 + "N" * 10 + "G" * 140), ("C7", "C" * 120),
            ("C9", "T" * 50)]
    recs += [(f"C{i}", "".join(rng.choice(list("ACGTN"), rng.integers(
        80, 3000)))) for i in range(10, 40)]
    ctgs = [(str(i), "".join(rng.choice(list("ACGT"), rng.integers(
        50, 2000)))) for i in range(1, 30, 2)]
    prefix = str(tmp_path / "x")
    tfastx.write_fasta(prefix + ".scafSeq", recs)
    tfastx.write_fasta(prefix + ".contig", ctgs)
    text = []
    for mod in (jfiles, tfiles):
        mod.write_scaf_statistics(prefix, known_genome_size=genome_size)
        with open(prefix + ".scafStatistics") as fh:
            text.append(fh.read())
    assert text[1] == text[0] and "N50\t" in text[1]
