"""Port parity of linear concatenation (graph/contig_merge.py), and the
int32 order-key fault of the JAX package that the port does not copy.

The JAX state after the contig stage's cleaning passes feeds both
packages (through soapdenovo_trans_tpu_torch.convert).  Exact
comparison (tolerance 0) of live prefixes."""

import types

import numpy as np
import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu import cli as jcli
from soapdenovo_trans_tpu.graph import contig_merge as jmerge
from soapdenovo_trans_tpu.graph import edge_clean as jclean
from soapdenovo_trans_tpu.io import libconfig as jlibconfig
from soapdenovo_trans_tpu.stages import pregraph as jpg
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import contig_merge as tmerge
from soapdenovo_trans_tpu_torch.graph import unitigs as tunitigs
from soapdenovo_trans_tpu_torch.ops import bits as tbits

K = 23


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    """(table, edges, arcs) of a 1,500-pair fixture after weak edges,
    tips, compaction and the unlike/high-arc filters (JAX)."""
    cfg = perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=30,
                         n_pairs=1500, seed=4)
    res = jpg.run_pregraph(
        jcli._CountingFactory(jlibconfig.parse_config(cfg), 4096), K)
    je = jclean.cut_tips(jclean.delete_weak_edges(res.edges, 20),
                         res.arcs, K)
    ja = jclean.compact_arcs(res.arcs, je)
    ja = jclean.delow_high_arc(jclean.delete_unlike_arcs(ja, je), je, 200)
    return res.table, je, ja


@pytest.fixture(scope="module")
def both(state):
    table, je, ja = state
    want = jmerge.concatenate(je, ja)
    got = tmerge.concatenate(convert.to_torch(je, "cpu"),
                             convert.to_torch(ja, "cpu"))
    return table, want, got


def _eq(want, got, n, msg=""):
    np.testing.assert_array_equal(np.asarray(want)[:n].astype(np.int64),
                                  got[:n].numpy().astype(np.int64),
                                  err_msg=msg)


def test_concatenate_matches_jax(both, state):
    _table, want, got = both
    n = int(want.n)
    assert got.n == n and 0 < n < int(state[1].n_edges)  # chains merged
    for field in ("from_node", "to_node", "length", "cvg", "twin",
                  "seq_off"):
        _eq(getattr(want, field), getattr(got, field), n, field)
    total = int(got.length.sum())
    _eq(want.seq_pool, got.seq_pool, total, "seq_pool")
    _eq(want.edge2contig, got.edge2contig, got.edge2contig.shape[0],
        "edge2contig")
    assert got.arcs.n == int(want.arcs.n) > 0
    for field in ("from_ed", "to_ed", "mult"):
        _eq(getattr(want.arcs, field), getattr(got.arcs, field), got.arcs.n,
            field)


def test_convert_contigs_round_trip(both):
    _table, want, _got = both
    port = convert.to_torch(want, "cpu")
    assert isinstance(port, tmerge.Contigs)
    assert isinstance(port.arcs, tarcs.ArcSet) and port.arcs.n == \
        int(want.arcs.n)
    back = convert.to_numpy(port, type(want), {"arcs": type(want.arcs)})
    assert type(back) is type(want) and type(back.arcs) is type(want.arcs)
    for w, b in zip(want[:-1] + tuple(want.arcs), back[:-1] + tuple(back.arcs)):
        np.testing.assert_array_equal(np.asarray(w), b)
        assert np.asarray(w).dtype == np.asarray(b).dtype


def test_contig_sequences_match_jax(both):
    table, want, got = both
    assert tmerge.contig_sequences(got, convert.to_torch(table, "cpu"), K) \
        == jmerge.contig_sequences(want, table, K)


def test_file_perm_and_reorder_match_jax(both):
    _table, want, got = both
    perm = jmerge.contig_file_perm(want, K)
    assert tmerge.contig_file_perm(got, K) == perm
    w = jmerge.reorder_contigs(want, perm)
    g = tmerge.reorder_contigs(got, perm)
    n = g.n
    for field in ("from_node", "to_node", "length", "cvg", "twin",
                  "seq_off"):
        _eq(getattr(w, field), getattr(g, field), n, field)
    _eq(w.edge2contig, g.edge2contig, g.edge2contig.shape[0], "edge2contig")
    for field in ("from_ed", "to_ed", "mult"):
        _eq(getattr(w.arcs, field), getattr(g.arcs, field), g.arcs.n, field)


def test_concatenate_with_every_edge_deleted(state):
    """No chain survives: one empty contig row, as every capacity keeps."""
    _table, je, ja = state
    je = je._replace(deleted=np.ones(je.length.shape[0], bool))
    want = jmerge.concatenate(je, ja)
    got = tmerge.concatenate(convert.to_torch(je, "cpu"),
                             convert.to_torch(ja, "cpu"))
    assert got.n == int(want.n) == 0 and got.arcs.n == int(want.arcs.n) == 0
    assert got.length.shape == (1,) and (got.edge2contig == -1).all()
    assert tmerge.contig_sequences(got, None, K) == []


def test_concatenate_two_edge_chains_past_int32_keys():
    """2**17 edges as 65,536 two-edge chains (32,768 chains and their
    twins).  The JAX package orders chain members by an int32 key,
    chain * (E + 1) + rank, so contig ids from 8,192 on may get a wrong
    sequence there (the JAX package builds 16,135 of these 65,536 wrong,
    the first at id 8,192); the port must match a direct numpy
    concatenation for every contig."""
    rng = np.random.default_rng(17)
    e = 1 << 17
    quads = e // 4     # edges 4j, 4j+1 chain; 4j+2, 4j+3 are their twins
    ids = np.arange(e).reshape(quads, 4)
    twin = np.empty(e, np.int64)
    twin[ids[:, 0]], twin[ids[:, 3]] = ids[:, 3], ids[:, 0]
    twin[ids[:, 1]], twin[ids[:, 2]] = ids[:, 2], ids[:, 1]
    length = rng.integers(1, 6, e)
    seq_off = np.cumsum(length) - length
    pool = rng.integers(0, 4, int(length.sum())).astype(np.uint8)
    t = torch.from_numpy
    eg = tunitigs.EdgeGraph(
        t(np.zeros(e, np.int64)), t(np.zeros(e, np.int64)), t(length),
        t(np.full(e, 50, np.int64)), t(twin), t(seq_off), t(pool), e,
        t(np.full(1, -1, np.int64)), t(np.full(1, -1, np.int64)),
        torch.zeros(e, dtype=torch.bool))
    f = np.concatenate([ids[:, 0], ids[:, 2]])   # 4j -> 4j+1, 4j+2 -> 4j+3
    to = f + 1
    order = np.argsort(f)
    aset = tarcs.ArcSet(t(f[order]), t(to[order]),
                        t(np.full(e // 2, 5, np.int64)), e // 2)
    ctg = tmerge.concatenate(eg, aset)
    assert ctg.n == e // 2 > (2**30) // (e + 1)

    # a one-row table whose k-mer (all A) heads every contig
    table = types.SimpleNamespace(
        keys=torch.zeros((1, tbits.words_for_k(K)), dtype=torch.int64))
    seqs = tmerge.contig_sequences(ctg, table, K)
    chars = np.frombuffer(tbits.BASE_CHARS.encode(), np.uint8)

    def edge_seq(x):
        return chars[pool[seq_off[x]:seq_off[x] + length[x]]].tobytes()

    e2c = ctg.edge2contig.numpy()
    heads = np.concatenate([ids[:, 0], ids[:, 2]])
    want = {int(e2c[h]): ("A" * K + (edge_seq(h) + edge_seq(h + 1)).decode())
            for h in heads}
    assert len(want) == ctg.n
    bad = [c for c in range(ctg.n) if seqs[c] != want[c]]
    assert not bad, f"{len(bad)} wrong contigs, first {bad[0]}"
    np.testing.assert_array_equal(ctg.length.numpy(),
                                  [len(want[c]) - K for c in range(ctg.n)])
    assert ctg.arcs.n == 0  # every arc was consumed inside a chain
