"""Port parity of contig connections (graph/connections.py): link
candidates from paired and single reads, their aggregation and the
insert-size estimate, against the JAX package on the same inputs; and
the scaff stage on tests/test_scaff.py's two-transcript scenario, from
reads to transcripts.  Integers throughout: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from soapdenovo_trans_tpu.graph import connections as jconn
from soapdenovo_trans_tpu.stages import map as jmap
from soapdenovo_trans_tpu.stages import scaff as jscaff
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import connections as tconn
from soapdenovo_trans_tpu_torch.stages import map as tmap
from soapdenovo_trans_tpu_torch.stages import scaff as tscaff
from tests import test_scaff as jts

CPU = torch.device("cpu")
K = jts.K


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    a = np.array(a)  # a writable copy
    return torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a)


def _eq(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy().astype(np.int64), msg)


def assert_conn_equal(want, got):
    n = int(want.n)
    assert got.n == n
    for field in tconn.ConnSet._fields[:-1]:
        _eq(np.asarray(getattr(want, field))[:n], getattr(got, field),
            field)


def _aggregate_both(f, t, g, se, v):
    want = jconn.aggregate(*(jnp.asarray(a) for a in (f, t, g, se, v)))
    got = tconn.aggregate(*(_t(a) for a in (f, t, g, se, v)))
    assert_conn_equal(want, got)
    return got


@pytest.mark.parametrize("seed,n,n_ctg", [(0, 500, 20), (1, 2000, 6),
                                          (2, 37, 300)])
def test_aggregate_matches_jax(seed, n, n_ctg):
    """Duplicate (from, to) pairs, negative gaps, invalid rows."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-1, n_ctg, n).astype(np.int32)
    t = rng.integers(-1, n_ctg, n).astype(np.int32)
    g = rng.integers(-300, 300, n).astype(np.int32)
    se = rng.random(n) < 0.4
    v = (rng.random(n) < 0.7) & (f >= 0) & (t >= 0)
    got = _aggregate_both(f, t, g, se, v)
    assert 0 < got.n <= v.sum() and (got.gap < 0).any()


def test_aggregate_floors_negative_means():
    f = np.array([1, 1, 2, 2, 2, 3], np.int32)
    t = np.array([2, 2, 3, 3, 3, 1], np.int32)
    g = np.array([-3, -4, 5, -7, 0, 9], np.int32)
    v = np.array([True, True, True, True, True, False])
    got = _aggregate_both(f, t, g, np.zeros(6, bool), v)
    assert got.gap.tolist() == [-4, -1] and got.weight.tolist() == [2, 3]


def test_aggregate_no_valid_row():
    z = np.zeros(4, np.int32)
    got = _aggregate_both(z - 1, z - 1, z, z > 0, z > 0)
    assert got.n == 0 and got.from_ctg.shape == (0,)


def _scenario(seed, kind):
    """tests/test_scaff.py's scenario: two transcripts sharing a repeat,
    coverage reads, and either FR pairs ("pe") or long single reads
    spanning the repeat ("se").  Returns JAX (table, ctg) and the
    linking reads."""
    rng = np.random.default_rng(seed)
    t1, t2, _parts = jts.build_scenario(rng)
    cov = []
    for t in (t1, t2):
        cov += [t[i:i + 50] for i in range(0, len(t) - 50 + 1, 5)]
        cov += [t[:50], t[-50:]]
    if kind == "pe":
        links = jts.pe_reads(rng, t1, 120, 40, 40) + \
            jts.pe_reads(rng, t2, 120, 40, 40)
    else:
        links = [t[i - 60:i + 60] for t in (t1, t2)
                 for i in range(110, 190, 4)]
    table, ctg = jts.assemble(cov + links)
    return table, ctg, links


@pytest.fixture(scope="module", params=["pe", "se"])
def scenario(request):
    """JAX and port placements of the linking reads on the scenario's
    contigs (the port's index built from the converted JAX contigs)."""
    table, ctg, reads = _scenario(7, request.param)
    map_len = 32 if request.param == "pe" else 20
    padded, lens = jts.pad(reads)
    index = jmap.build_contig_index(ctg, table, K)
    want = jmap.map_reads(padded, lens, index, K, map_len=map_len)
    tctg, ttable = convert.to_torch(ctg, CPU), convert.to_torch(table, CPU)
    got = tmap.map_reads(_t(padded), _t(lens),
                         tmap.build_contig_index(tctg, ttable, K), K,
                         map_len=map_len)
    for field in tmap.ReadPlacements._fields:
        _eq(getattr(want, field), getattr(got, field), field)
    return request.param, table, ctg, tctg, ttable, padded, want, got


def test_link_candidates_match_jax(scenario):
    kind, _table, ctg, tctg, _tt, padded, want, got = scenario
    full_len = ctg.length + K
    if kind == "pe":
        jf = jconn.pe_link_candidates(want.ctg, want.pos, ctg.twin,
                                      full_len, 120, K)
        tf = tconn.pe_link_candidates(got.ctg, got.pos, tctg.twin,
                                      tctg.length + K, 120, K)
        g_ok = np.ones(jf[0].shape[0], bool)
    else:
        r, p = padded.shape[0], padded.shape[1] - K + 1
        unique = (np.arange(ctg.length.shape[0]) < int(ctg.n)) & \
            (np.asarray(full_len) >= 100)
        jf = jconn.se_link_candidates(
            want.g_ctg, want.g_ctg_off, want.g_read_off, want.g_valid, r, p,
            K, twin=ctg.twin, ctg_len=full_len, unique=jnp.asarray(unique))
        tf = tconn.se_link_candidates(
            got.g_ctg, got.g_ctg_off, got.g_read_off, got.g_valid, r, p, K,
            twin=tctg.twin, ctg_len=tctg.length + K,
            unique=torch.from_numpy(unique))
        g_ok = np.asarray(jf[3])  # gaps of invalid slots are unspecified
    for name, a, b in zip(("from", "to", "gap", "valid"), jf, tf):
        keep = g_ok if name == "gap" else np.ones(b.shape[0], bool)
        np.testing.assert_array_equal(np.asarray(a)[keep],
                                      b.numpy()[keep], name)
    assert bool(tf[3].any())


def test_scenario_transcripts_match_jax(scenario):
    """Aggregated links and run_scaff's records, transcripts and
    rendered placements, as tests/test_scaff.py runs them."""
    kind, table, ctg, tctg, ttable, padded, want, got = scenario
    full_len = ctg.length + K
    if kind == "pe":
        f, t, g, v = jconn.pe_link_candidates(want.ctg, want.pos, ctg.twin,
                                              full_len, 120, K)
        se = jnp.zeros_like(v)
    else:
        unique = (np.arange(ctg.length.shape[0]) < int(ctg.n)) & \
            (np.asarray(full_len) >= 100)
        f, t, g, v = jconn.se_link_candidates(
            want.g_ctg, want.g_ctg_off, want.g_read_off, want.g_valid,
            padded.shape[0], padded.shape[1] - K + 1, K, twin=ctg.twin,
            ctg_len=full_len, unique=jnp.asarray(unique))
        se = jnp.ones_like(v)
    conn = jconn.aggregate(f, t, g, se, v)
    tconn_set = _aggregate_both(f, t, g, se, v)
    assert tconn_set.n > 0
    jres = jscaff.run_scaff(ctg, conn, K, table,
                            jscaff.ScaffParams(min_unique_len=100),
                            ctg_arcs=ctg.arcs)
    tres = tscaff.run_scaff(tctg, tconn_set, K, ttable,
                            tscaff.ScaffParams(min_unique_len=100),
                            ctg_arcs=tctg.arcs)
    assert tres.recs == jres.recs
    assert any(h.startswith("scaffold") for h, _ in tres.recs)
    assert [(tr.locus, tr.index, tr.kind, tr.contigs, tr.gaps)
            for tr in tres.transcripts] == \
        [(tr.locus, tr.index, tr.kind, tr.contigs, tr.gaps)
         for tr in jres.transcripts]
    assert tres.placements == jres.placements
    assert tres.routes == jres.routes and tres.n_runs == jres.n_runs
    assert tres.stats == jres.stats


def test_estimate_insert_size_matches_jax():
    """Pairs on one contig (some longer than the declared insert), pairs
    across contigs, unmapped mates."""
    rng = np.random.default_rng(11)
    n_pairs, n_ctg = 400, 10
    ctg = rng.integers(-1, n_ctg, 2 * n_pairs).astype(np.int32)
    same = rng.random(n_pairs) < 0.6
    ctg[1::2] = np.where(same, ctg[0::2] ^ 1, ctg[1::2])
    ctg[1::2] = np.where(ctg[0::2] < 0, -1, ctg[1::2])
    pos = rng.integers(-20, 400, 2 * n_pairs).astype(np.int32)
    twin = (np.arange(n_ctg) ^ 1).astype(np.int32)
    ctg_len = rng.integers(150, 1200, n_ctg).astype(np.int32)
    for declared, min_pairs in ((300, 100), (300, 10_000), (600, 5)):
        want = jconn.estimate_insert_size(
            *(jnp.asarray(a) for a in (ctg, pos, twin, ctg_len)), declared,
            min_pairs)
        got = tconn.estimate_insert_size(
            *(_t(a) for a in (ctg, pos, twin, ctg_len)), declared, min_pairs)
        assert got == tuple(int(x) for x in want)
    sizes, ok = tconn.same_contig_fragments(
        *(_t(a) for a in (ctg, pos, twin, ctg_len)))
    jsizes, jok = jconn.same_contig_fragments(
        *(jnp.asarray(a) for a in (ctg, pos, twin, ctg_len)))
    _eq(jsizes, sizes)
    _eq(jok, ok)
    assert bool(ok.any())


def test_conn_set_convert_round_trip():
    rng = np.random.default_rng(3)
    f, t = (rng.integers(0, 9, 50).astype(np.int32) for _ in range(2))
    g = rng.integers(-50, 50, 50).astype(np.int32)
    want = jconn.aggregate(*(jnp.asarray(a) for a in (
        f, t, g, np.zeros(50, bool), np.ones(50, bool))))
    got = convert.to_torch(want, CPU)
    assert isinstance(got, tconn.ConnSet) and got.n == int(want.n)
    back = convert.to_numpy(got, jconn.ConnSet)
    for a, b in zip(want, back):
        np.testing.assert_array_equal(np.asarray(a), b)
