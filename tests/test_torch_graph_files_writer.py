"""The port's pregraph writer (``io/graph_files.write_pregraph_files``)
against the JAX package's per-record writer, which reads the same CPU
tensors: ``.vertex`` and ``.preArc`` byte for byte, ``.edge.gz`` after
gunzip, at every hex width (one, two and four 64-bit words) on
synthetic graphs with the edge cases the format has; ``.edge.gz`` as one
level-9 gzip member whose bytes do not depend on the deflate's worker
count; and ``edge_file_ids`` against the JAX package's sequential loop
on twin arrays that are not an involution."""

import gzip
import zlib

import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.io import graph_files as jgf
from soapdenovo_trans_tpu_torch.graph import arcs as arcs_mod
from soapdenovo_trans_tpu_torch.graph import unitigs
from soapdenovo_trans_tpu_torch.io import graph_files as gf
from soapdenovo_trans_tpu_torch.ops import bits, dictionary


# -- synthetic graphs ----------------------------------------------------

def _kmers(rng, n, k):
    """(n, W) int64 lanes of random k-mers; row 0 all A (zero), row 1
    all G (every bit of the 2K set), row 2 a single T at the end."""
    masks = bits.mask_list(k)
    lanes = np.stack([rng.integers(0, mk + 1, n, dtype=np.int64)
                      for mk in masks], 1)
    lanes[0] = 0
    lanes[1] = masks
    lanes[2] = 0
    lanes[2, -1] = 2
    return lanes


def _twins(n_pairs):
    """Rows 0 palindrome; 1..2n_pairs paired (i, i+1); then an
    asymmetric pair (a -> b, b -> a's pair-mate), a row whose twin is
    out of range, and one more palindrome."""
    twin = [0]
    for p in range(n_pairs):
        a = 1 + 2 * p
        twin += [a + 1, a]
    n = len(twin)
    twin[3] = n            # row 3 names row n, whose twin is row 4
    twin += [4, -1, n + 2]  # row n+1: twin -1; row n+2: palindrome
    return np.asarray(twin, np.int64)


def _graph(k, seed, n_pairs=30):
    rng = np.random.default_rng(seed)
    n_v = 40
    keys = _kmers(rng, n_v, k)
    twin = _twins(n_pairs)
    n_e = twin.shape[0]
    length = rng.integers(0, 350, n_e)
    length[1:7] = [0, 1, 99, 100, 101, 200]
    length[n_e - 1] = 0
    seq_off = np.zeros(n_e, np.int64)
    seq_off[1:] = np.cumsum(length)[:-1]
    rng.shuffle(seq_off)  # records read the pool out of order
    pool = rng.integers(0, 4, int(seq_off.max() + length.max() + 1),
                        dtype=np.uint8)
    from_node = rng.integers(0, 2 * n_v, n_e)
    to_node = rng.integers(0, 2 * n_v, n_e)
    from_node[:3] = [0, 1, 3]  # the zero k-mer forward and reversed
    to_node[:3] = [2, 4, 5]
    cvg = rng.integers(0, 10 ** rng.integers(1, 12, n_e))
    cvg[0] = 0
    a_n = 150
    from_ed = rng.integers(0, n_e, a_n)
    from_ed[:6] = [9, 2, 9, 2, 0, 9]  # repeated, out of order
    to_ed = rng.integers(0, n_e, a_n)
    mult = rng.integers(0, 10 ** rng.integers(1, 10, a_n))

    t = torch.from_numpy
    cap = n_v + 3
    pad_keys = np.full((cap, keys.shape[1]), dictionary.SENTINEL, np.int64)
    pad_keys[:n_v] = keys
    zeros = torch.zeros(cap, dtype=torch.int32)
    table = dictionary.KmerTable(
        t(pad_keys), zeros, zeros.new_zeros((cap, 4)),
        zeros.new_zeros((cap, 4)), n_v, torch.zeros(cap, dtype=torch.bool))
    extra = 5  # capacity rows past n_edges, which no file may read
    none = torch.full((2 * n_v,), -1, dtype=torch.int64)

    def padded(a, fill):
        return t(np.concatenate([a, np.full(extra, fill, np.int64)]))

    edges = unitigs.EdgeGraph(
        padded(from_node, -1), padded(to_node, -1), padded(length, 0),
        padded(cvg, 0), padded(twin, -1), padded(seq_off, 0), t(pool), n_e,
        none, none.clone(), torch.zeros(n_e + extra, dtype=torch.bool))
    aset = arcs_mod.ArcSet(padded(from_ed, -1), padded(to_ed, -1),
                           padded(mult, 0), a_n)
    return table, edges, aset


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("k", [13, 23, 31, 33, 63, 65, 127])
def test_writer_matches_the_plain_writer(k, tmp_path):
    table, edges, aset = _graph(k, seed=k)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    n_vt = gf.write_pregraph_files(got, table, edges, aset, k)
    assert n_vt == jgf.write_pregraph_files(want, table, edges, aset, k)
    for ext in (".vertex", ".edge.gz", ".preArc"):
        assert _read(got + ext) == _read(want + ext), ext
    text = _read(got + ".edge.gz")
    assert (b",0x0," in text) == (k <= 31)  # the MER31 quirk
    assert b"\n\n>" in text  # an edge of no bases: one empty line
    with open(got + ".edge.gz", "rb") as fh:
        raw = fh.read()
    member = zlib.decompressobj(31)
    assert member.decompress(raw) == text
    assert member.eof and member.unused_data == b""  # one gzip member
    assert raw[8] == 2  # XFL: written at the slowest level, 9


@pytest.mark.parametrize("k", [23, 127])
def test_writer_in_small_blocks(k, tmp_path, monkeypatch):
    """Blocks of records shorter than some records: the one gzip
    member still holds the same text."""
    monkeypatch.setattr(gf, "_BLOCK_BASES", 300)
    table, edges, aset = _graph(k, seed=k + 1)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    gf.write_pregraph_files(got, table, edges, aset, k)
    jgf.write_pregraph_files(want, table, edges, aset, k)
    assert _read(got + ".edge.gz") == _read(want + ".edge.gz")
    with open(got + ".edge.gz", "rb") as fh:
        member = zlib.decompressobj(31)
        member.decompress(fh.read())
    assert member.eof and member.unused_data == b""


def _member(raw):
    """The text of a gzip file that must be one member, written at the
    slowest level (XFL 2)."""
    member = zlib.decompressobj(31)
    text = member.decompress(raw)
    assert member.eof and member.unused_data == b""
    assert raw[8] == 2
    return text


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("k", [23, 127])
def test_edge_file_deflated_in_parallel_chunks(k, workers, tmp_path,
                                               monkeypatch):
    """Chunks of 16 KiB deflated on ``workers`` threads (at most one
    queued a worker), blocks of records of 20,000 bases: chunks span
    blocks and cut records.  The text is the plain writer's, the file
    one member at level 9, its bytes those of one worker, and its size
    at most 0.5% over gzip's serial level 9."""
    monkeypatch.setattr(gf, "_CHUNK", 1 << 14)
    monkeypatch.setattr(gf, "_BLOCK_BASES", 20_000)
    monkeypatch.setattr(gf, "_IN_FLIGHT", 1)
    table, edges, aset = _graph(k, seed=k + 2, n_pairs=300)
    jgf.write_pregraph_files(str(tmp_path / "jax"), table, edges, aset, k)
    raw = {}
    for w in (1, workers):
        monkeypatch.setattr(gf, "_deflate_workers", lambda w=w: w)
        got = str(tmp_path / f"port{w}")
        gf.write_pregraph_files(got, table, edges, aset, k)
        with open(got + ".edge.gz", "rb") as fh:
            raw[w] = fh.read()
    text = _member(raw[workers])
    assert text == _read(str(tmp_path / "jax.edge.gz"))
    assert len(text) > 4 * gf._CHUNK  # several chunks
    assert raw[workers] == raw[1]
    assert len(raw[workers]) <= 1.005 * len(gzip.compress(text, 9))


@pytest.mark.parametrize("workers", [1, 3])
def test_no_edges_write_one_empty_member(workers, tmp_path, monkeypatch):
    monkeypatch.setattr(gf, "_deflate_workers", lambda: workers)
    table, edges, aset = _graph(23, seed=2)
    got = str(tmp_path / "port")
    gf.write_pregraph_files(got, table, edges._replace(n_edges=0),
                            aset._replace(n=0), 23)
    with open(got + ".edge.gz", "rb") as fh:
        assert _member(fh.read()) == b""


def test_writer_on_an_empty_graph(tmp_path):
    table, edges, aset = _graph(23, seed=1)
    edges = edges._replace(n_edges=0)
    aset = aset._replace(n=0)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert gf.write_pregraph_files(got, table, edges, aset, 23) == \
        jgf.write_pregraph_files(want, table, edges, aset, 23) == 0
    for ext in (".vertex", ".edge.gz", ".preArc"):
        assert _read(got + ext) == _read(want + ext), ext


def _random_twin(rng, n, n_odd):
    """An involution over n rows with palindromes, then n_odd rows
    pointed elsewhere (another row, itself, or out of range)."""
    perm = rng.permutation(n)
    twin = np.arange(n, dtype=np.int64)
    n_pair = (n - n // 10) // 2
    a, b = perm[:n_pair], perm[n_pair: 2 * n_pair]
    twin[a], twin[b] = b, a
    for r in rng.choice(n, n_odd, replace=False):
        twin[r] = rng.choice([rng.integers(0, n), r, -1, n + 7])
    return twin


@pytest.mark.parametrize("seed,n,n_odd", [
    (0, 1, 0), (1, 2, 1), (2, 50, 0), (3, 50, 3), (4, 400, 1),
    (5, 400, 40), (6, 400, 400), (7, 3000, 2)])
def test_edge_file_ids_match_the_loop(seed, n, n_odd):
    rng = np.random.default_rng(seed)
    twin = _random_twin(rng, n, n_odd)
    edges = unitigs.EdgeGraph(*([None] * 4), torch.from_numpy(twin),
                              *([None] * 2), n, *([None] * 3))
    file_id, order, nxt = gf.edge_file_ids(edges)
    want_id, want_order, want_nxt = jgf.edge_file_ids(edges)
    assert np.array_equal(file_id, want_id)
    assert np.array_equal(order, np.asarray(want_order, np.int64))
    assert order.dtype == np.int64 and nxt == want_nxt


@pytest.mark.parametrize("twin", [
    [1, 2, 1],          # a row names one of a pair, before it
    [2, 2, 1],          # ... after it
    [1, 2, 3, 2],       # a chain into a pair
    [3, 2, 1, 0, 0],    # two rows name one row
    [1, 0, 0, 5, 3, -1],
])
def test_edge_file_ids_on_chains(twin):
    twin = np.asarray(twin, np.int64)
    edges = unitigs.EdgeGraph(*([None] * 4), torch.from_numpy(twin),
                              *([None] * 2), twin.shape[0], *([None] * 3))
    file_id, order, nxt = gf.edge_file_ids(edges)
    want_id, want_order, want_nxt = jgf.edge_file_ids(edges)
    assert np.array_equal(file_id, want_id)
    assert np.array_equal(order, np.asarray(want_order, np.int64))
    assert nxt == want_nxt
