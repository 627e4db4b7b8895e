"""Port parity of the map stage (stages/map.py): the contig k-mer index,
read placement and voting, against the JAX package on the same inputs
(through soapdenovo_trans_tpu_torch.convert), at K = 23 and 31 on the
scenarios of tests/test_map.py, and ``vote`` alone on random hit
matrices.  Integers throughout: tolerance 0."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from soapdenovo_trans_tpu.graph import arcs as jarcs
from soapdenovo_trans_tpu.graph import contig_merge as jmerge
from soapdenovo_trans_tpu.graph import dbg as jdbg
from soapdenovo_trans_tpu.graph import unitigs as junitigs
from soapdenovo_trans_tpu.ops import bits as jbits
from soapdenovo_trans_tpu.ops import dictionary as jdict
from soapdenovo_trans_tpu.ops import kmer as jkmer
from soapdenovo_trans_tpu.stages import map as jmap
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.stages import map as tmap

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def unique_kmer_seq(rng, n, k, taken):
    """Random sequence whose canonical k-mers are unique, also against
    (and added to) ``taken``."""
    while True:
        s = "".join(rng.choice(list("ACGT"), size=n))
        cans = {min(s[j:j + k], jbits.revcomp_str(s[j:j + k]))
                for j in range(n - k + 1)}
        if len(cans) == n - k + 1 and not cans & taken:
            taken |= cans
            return s


def pad(reads):
    codes = np.full((len(reads), max(len(s) for s in reads)), 4, np.uint8)
    for i, s in enumerate(reads):
        codes[i, :len(s)] = jbits.encode_seq(s)
    return codes, np.asarray([len(s) for s in reads], np.int32)


def assemble(seqs, k):
    """JAX contigs of error-free reads (tests/test_map.py's pipeline)."""
    codes, lens = pad(seqs)
    codes, lens = jnp.asarray(codes), jnp.asarray(lens)
    table = jdict.build(jkmer.chop_reads(codes, lens, k), k)
    eg = junitigs.condense(jdbg.build_dbg(table, k), table, k)
    patch = jarcs.build_patch(eg, table, k)
    f, t, v = jarcs.thread_reads(codes, lens, table, eg, patch, k)
    return table, jmerge.concatenate(eg, jarcs.count_arcs(f, t, v, eg.twin))


def both_indexes(table, ctg, k):
    want = jmap.build_contig_index(ctg, table, k)
    got = tmap.build_contig_index(convert.to_torch(ctg, CPU),
                                  convert.to_torch(table, CPU), k)
    n = int(want.n)
    assert got.n == n > 0
    for field in ("keys", "ctg", "pos", "is_rc"):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, field))[:n].astype(np.int64),
            getattr(got, field)[:n].numpy().astype(np.int64), field)
    return want, got


def both_placements(reads, want_index, got_index, k, map_len):
    codes, lens = pad(reads)
    want = jmap.map_reads(jnp.asarray(codes), jnp.asarray(lens), want_index,
                          k, map_len=map_len)
    got = tmap.map_reads(torch.from_numpy(codes), torch.from_numpy(lens),
                         got_index, k, map_len=map_len)
    assert_placements_equal(want, got)
    return got


def assert_placements_equal(want, got):
    for field in tmap.ReadPlacements._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, field)).astype(np.int64),
            getattr(got, field).numpy().astype(np.int64), field)


@pytest.mark.parametrize("k", [23, 31])
def test_exact_placement(k):
    rng = np.random.default_rng(100 + k)
    t = unique_kmer_seq(rng, 200, k, set())
    table, ctg = assemble([t], k)
    want_index, got_index = both_indexes(table, ctg, k)
    seqs = jmerge.contig_sequences(ctg, table, k)
    reads = [t[30:80], t[100:150], jbits.revcomp_str(t[50:100])]
    pl = both_placements(reads, want_index, got_index, k, 32)
    for i, read in enumerate(reads):
        c, p = int(pl.ctg[i]), int(pl.pos[i])
        assert c >= 0 and seqs[c][p:p + len(read)] == read


@pytest.mark.parametrize("k", [23, 31])
def test_multi_not_met(k):
    rng = np.random.default_rng(200 + k)
    t = unique_kmer_seq(rng, 200, k, set())
    table, ctg = assemble([t], k)
    want_index, got_index = both_indexes(table, ctg, k)
    # 3 k-mers < multi = 5
    pl = both_placements([t[30:30 + k + 2]], want_index, got_index, k, 32)
    assert int(pl.ctg[0]) == -1


def _y_branch(rng, k):
    """p + {A, C} + branch, with no repeated k-mer outside p."""
    while True:
        taken = set()
        p = unique_kmer_seq(rng, 80, k, taken)
        t1 = p + "A" + unique_kmer_seq(rng, 40, k, taken)
        t2 = p + "C" + unique_kmer_seq(rng, 40, k, taken)
        cnt = Counter(min(t[j:j + k], jbits.revcomp_str(t[j:j + k]))
                      for t in (t1, t2) for j in range(len(t) - k + 1))
        p_kmers = {min(p[j:j + k], jbits.revcomp_str(p[j:j + k]))
                   for j in range(len(p) - k + 1)}
        if all(c == 1 or (c == 2 and km in p_kmers)
               for km, c in cnt.items()):
            return p, t1, t2


@pytest.mark.parametrize("k", [23, 31])
def test_ambiguous_kmers_dropped(k):
    rng = np.random.default_rng(300 + k)
    p, t1, t2 = _y_branch(rng, k)
    table, ctg = assemble([t1, t2], k)
    _want, got = both_indexes(table, ctg, k)
    idx = {jbits.kmer_to_string(row, k) for row in got.keys[:got.n].numpy()}

    def canon(w):  # code order (A0 C1 T2 G3), as the stored keys
        rc = jbits.revcomp_str(w)
        code = [jbits.BASE_CHARS.index(c) for c in w]
        return w if code <= [jbits.BASE_CHARS.index(c) for c in rc] else rc

    assert canon(p[-k:]) not in idx      # the junction k-mer repeats
    assert canon(p[30:30 + k]) in idx    # a mid-p k-mer occurs once


@pytest.mark.parametrize("k", [23, 31])
def test_footprint_gap_spanning(k):
    rng = np.random.default_rng(400 + k)
    taken = set()
    t1 = unique_kmer_seq(rng, 150, k, taken)
    t2 = unique_kmer_seq(rng, 150, k, taken)
    table, ctg = assemble([t1, t2], k)
    want_index, got_index = both_indexes(table, ctg, k)
    read = t1[-(k + 10):] + t2[:k + 10]  # 11 k-mers on each contig
    pl = both_placements([read], want_index, got_index, k, 60)
    assert int(pl.ctg[0]) == -1          # multi > 11
    pl = both_placements([read], want_index, got_index, k, 20)
    assert bool(pl.footprint[0]) and int(pl.ctg[0]) >= 0


@pytest.mark.parametrize("seed,r,p,n_ctg", [
    (0, 64, 40, 3), (1, 200, 78, 6), (2, 37, 9, 2), (3, 128, 70, 40)])
def test_vote_matches_jax(seed, r, p, n_ctg):
    """Random hit matrices over few contigs: many groups per read, many
    with equal votes, hits missing at random."""
    rng = np.random.default_rng(seed)
    k, n_rows = 23, 2 * n_ctg
    ctg_of = rng.integers(-1, n_ctg, (r, p)).astype(np.int32)
    kpos = rng.integers(0, 400, (r, p)).astype(np.int32)
    stored_rc = rng.random((r, p)) < 0.5
    win_rc = rng.random((r, p)) < 0.5
    lengths = rng.integers(k, k + p, r).astype(np.int32)
    ctg_len = rng.integers(k + 2, 500, n_rows).astype(np.int32)
    twin = (np.arange(n_rows) ^ 1).astype(np.int32)
    for map_len in (28, 32):
        want = jmap.vote(*(jnp.asarray(a) for a in (
            ctg_of, kpos, stored_rc, win_rc, lengths, ctg_len, twin)),
            k, map_len)
        got = tmap.vote(*(torch.from_numpy(a.astype(np.int64)
                                           if a.dtype != bool else a)
                          for a in (ctg_of, kpos, stored_rc, win_rc,
                                    lengths, ctg_len, twin)), k, map_len)
        assert_placements_equal(want, got)
        assert got.g_valid.any() and (got.ctg >= 0).any()


def test_read_placements_convert_round_trip():
    rng = np.random.default_rng(5)
    t = unique_kmer_seq(rng, 200, 23, set())
    table, ctg = assemble([t], 23)
    want_index, _got = both_indexes(table, ctg, 23)
    codes, lens = pad([t[10:60], t[120:170]])
    want = jmap.map_reads(jnp.asarray(codes), jnp.asarray(lens), want_index,
                          23, map_len=32)
    back = convert.to_numpy(convert.to_torch(want, CPU), jmap.ReadPlacements)
    for a, b in zip(want, back):
        np.testing.assert_array_equal(np.asarray(a), b)
    index = convert.to_torch(want_index, CPU)
    assert isinstance(index, tmap.ContigIndex) and index.n == int(want_index.n)
