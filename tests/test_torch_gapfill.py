"""Local gap assembly of the PyTorch port against the JAX package's
``graph/gapfill``: the eight cases of ``tests/test_gapfill.py`` through
both ``fill_gaps`` (filled, fill_seq and overlap equal element for
element), and ``build_local_tables`` / ``_local_graph`` / ``_bfs`` /
``_trace`` on random tables, live prefixes compared.  Integer and string
results: tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.graph import gapfill as jgf
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import gapfill as tgf
from soapdenovo_trans_tpu_torch.ops import bits as tbits

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _reads_over(seq, length=30, stride=2):
    return [tbits.encode_seq(seq[i: i + length])
            for i in range(0, len(seq) - length + 1, stride)]


def _gap_case(rng, k, gap_len, stride=2, flank=80):
    left, gap, right = (_rand_seq(rng, flank), _rand_seq(rng, gap_len),
                        _rand_seq(rng, flank))
    region = left[-(k + 25):] + gap + right[:k + 25]
    return left, gap, right, _reads_over(region, k + 15, stride)


def _positive(rng, k):
    left, gap, right, reads = _gap_case(rng, k, 25)
    return [(left, right, len(gap))], [reads], {}


def _no_reads(rng, k):
    return [(_rand_seq(rng, 60 + k), _rand_seq(rng, 60 + k), 20)], [[]], {}


def _overlap_merge(rng, k):
    core = _rand_seq(rng, 120 + 2 * k)
    return [(core[:80 + k], core[60 + k:], -20)], [[]], {}


def _small_overlap_by_walk(rng, k):
    core = _rand_seq(rng, 100 + 2 * k)
    cut = 60 + k
    return [(core[:cut], core[cut - (k - 1):], -(k - 1))], [[]], {}


def _mixed_batch(rng, k):
    juncs, greads = [], []
    for gi in range(6):
        left, gap, right, reads = _gap_case(rng, k, 10 + 3 * gi, flank=70 + k)
        juncs.append((left, right, len(gap)))
        greads.append(reads)
    # one overlap junction and one without reads share the batch
    core = _rand_seq(rng, 120 + 2 * k)
    juncs += [(core[:80 + k], core[60 + k:], -20),
              (_rand_seq(rng, 60 + k), _rand_seq(rng, 60 + k), 15)]
    greads += [[], []]
    return juncs, greads, {}


def _window_reject(rng, k):
    left, _gap, right, reads = _gap_case(rng, k, 30)
    return [(left, right, 500)], [reads], {"tol": 50}


def _decoy_branch(rng, k):
    left, gap, right, reads = _gap_case(rng, k, 30, stride=4)
    decoy = left[-(k + 5):] + gap[:10] + _rand_seq(rng, 30 + k)
    reads = reads + 8 * _reads_over(decoy, k + 15, 4)
    return [(left, right, len(gap))], [reads], {}


def _cross_gap_fallback(rng, k):
    left, right = _rand_seq(rng, 70 + k), _rand_seq(rng, 70 + k)
    gap = _rand_seq(rng, 12) + "N" + _rand_seq(rng, 12)
    span = left[-k:] + gap + right[:k]
    return ([(left, right, len(gap)), (left, right, len(gap))],
            [[tbits.encode_seq(span)],
             [tbits.encode_seq(tbits.revcomp_str(span))]], {})


CASES = {"positive_gap": _positive, "no_reads": _no_reads,
         "overlap_merge": _overlap_merge,
         "small_overlap_by_walk": _small_overlap_by_walk,
         "mixed_batch": _mixed_batch, "window_reject": _window_reject,
         "decoy_branch": _decoy_branch,
         "reads_cross_gap_fallback": _cross_gap_fallback}
# which cases must close their gaps (the others must leave them open)
FILLS = {"no_reads": False, "window_reject": False}


@pytest.mark.parametrize("k", [15, 23, 31])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_gaps_matches_jax(case, k):
    rng = np.random.default_rng(sum(map(ord, case)) + k)
    juncs, greads, kw = CASES[case](rng, k)
    want = jgf.fill_gaps(juncs, greads, k, **kw)
    got = tgf.fill_gaps(juncs, greads, k, CPU, **kw)
    assert convert.gapfill_plain(got) == convert.gapfill_plain(want)
    if case in FILLS:
        assert not got.filled.any()
    elif case == "mixed_batch":
        assert got.filled[:7].all() and not got.filled[7]
    else:
        assert got.filled.all()
    assert set(got.phase_seconds) >= {"overlap"}


def test_fill_gaps_wide_lanes_k63():
    """K = 63: four-lane k-mers, five-lane table keys."""
    rng = np.random.default_rng(63)
    juncs, greads, _ = _mixed_batch(rng, 63)
    want = jgf.fill_gaps(juncs, greads, 63)
    got = tgf.fill_gaps(juncs, greads, 63, CPU)
    assert convert.gapfill_plain(got) == convert.gapfill_plain(want)
    assert got.filled[:7].all()


def test_fill_gaps_empty():
    got = tgf.fill_gaps([], [], 23, CPU)
    assert convert.gapfill_plain(got) == ([], [], [])


def _random_tagged_kmers(rng, k, n, gaps):
    """n (gap id, canonical k-mer, valid) rows from a small pool of
    overlapping windows, so that tables hold successors and repeats."""
    w = tbits.words_for_k(k)
    seqs = [_rand_seq(rng, k + 40) for _ in range(gaps)]
    gid = rng.integers(0, gaps, n)
    kmers = np.zeros((n, w), np.int64)
    for i in range(n):
        s = seqs[gid[i]]
        j = rng.integers(0, len(s) - k + 1)
        win = s[j:j + k]
        kmers[i] = tbits.kmer_from_string(min(win, tbits.revcomp_str(win))
                                          if rng.random() < 0.5 else win)
    t_km = torch.from_numpy(kmers)
    can, _ = tbits.canonical(t_km, k)
    return gid.astype(np.int32), can.numpy(), rng.random(n) < 0.9


@pytest.mark.parametrize("k", [23, 31])
def test_tables_graph_bfs_trace_match_jax(k):
    rng = np.random.default_rng(k)
    gaps, n = 5, 600
    gid, kmers, valid = _random_tagged_kmers(rng, k, n, gaps)

    jt = jgf.build_local_tables(jnp.asarray(gid), jnp.asarray(
        kmers.astype(np.uint32)), jnp.asarray(valid), 1024)
    tt = tgf.build_local_tables(torch.from_numpy(gid), torch.from_numpy(kmers),
                                torch.from_numpy(valid))
    live = tt.keys.shape[0]
    assert 0 < live < n
    got = convert.to_numpy(tt)
    np.testing.assert_array_equal(got.keys, np.asarray(jt.keys)[:live])
    np.testing.assert_array_equal(got.count, np.asarray(jt.count)[:live])
    assert not np.asarray(jt.count)[live:].any()
    # and the JAX tables carried across give the same port tables
    back = convert.to_torch(type(jt)(np.asarray(jt.keys)[:live],
                                     np.asarray(jt.count)[:live]), CPU)
    assert torch.equal(back.keys, tt.keys) and torch.equal(back.count,
                                                           tt.count)

    jsucc, jcnt = jgf._local_graph(jt, k)
    tsucc, tcnt = tgf._local_graph(tt, k)
    np.testing.assert_array_equal(tsucc.numpy(), np.asarray(jsucc)[:2 * live])
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt)[:2 * live])
    assert (tsucc >= 0).any()

    starts = rng.integers(0, 2 * live, gaps)
    starts[1] = -1  # an inactive gap
    targets = rng.integers(0, 2 * live, gaps)
    for steps in (3, 64):
        jd = jgf._bfs(jsucc, jnp.asarray(starts.astype(np.int32)), steps)
        td = tgf._bfs(tsucc, torch.from_numpy(starts), steps)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[:2 * live])

    # distance to the target, as fill_gaps forms it, then the trace
    jdt = jgf._bfs(jsucc, jnp.asarray((targets ^ 1).astype(np.int32)), 64)
    jdt = jdt.reshape(-1, 2)[:, ::-1].reshape(-1)
    tdt = tgf._bfs(tsucc, torch.from_numpy(targets ^ 1), 64).view(
        -1, 2).flip(1).reshape(-1)
    np.testing.assert_array_equal(tdt.numpy(), np.asarray(jdt)[:2 * live])
    jb, jok = jgf._trace(jsucc, jcnt, jdt, jnp.asarray(
        starts.astype(np.int32)), jnp.asarray(targets.astype(np.int32)), 64)
    tb, tok = tgf._trace(tsucc, tcnt, tdt, torch.from_numpy(starts),
                         torch.from_numpy(targets), 64)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_local_graph_chunks_do_not_change_it(monkeypatch):
    rng = np.random.default_rng(5)
    gid, kmers, valid = _random_tagged_kmers(rng, 23, 400, 3)
    tt = tgf.build_local_tables(torch.from_numpy(gid), torch.from_numpy(kmers),
                                torch.from_numpy(valid))
    whole = tgf._local_graph(tt, 23)
    monkeypatch.setattr(tgf, "GRAPH_ROWS", 7)
    parts = tgf._local_graph(tt, 23)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])
