"""Port parity of the Tour-Bus bubble pass (graph/tourbus.py).

The JAX package's graphs (built by the helpers of tests/test_bubbles.py)
feed both packages through soapdenovo_trans_tpu_torch.convert; the
port's pinch must give the same deleted mask, coverage, arc table and
counters as the JAX pinch run with the port's arc rule laid over its
waves (``tests/tourbus_rule.py``: the JAX wave's rows, less the rows the
rule drops, recomputed from the wave's paths and the edges' end nodes).
The JAX pinch without the rule leaves a row that does not join on the
multi-node bubble; the port's leaves none.  Exact comparison (tolerance
0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.graph import tourbus as jtour
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import bubbles as tbubbles
from soapdenovo_trans_tpu_torch.graph import tourbus as ttour
from soapdenovo_trans_tpu_torch.kernels import lcs
from tests.test_bubbles import (K, _multinode_bubble_reads, build,
                                snp_variant, unique_kmer_seq)
from tests.tourbus_rule import rule_on


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lcs_reference(a, b):
    f = np.zeros((len(a) + 1, len(b) + 1), np.int64)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            f[i + 1, j + 1] = f[i, j] + 1 if x == y else \
                max(f[i, j + 1], f[i + 1, j])
    return int(f[-1, -1])


def test_lcs_scores_match_jax():
    rng = np.random.default_rng(8)
    cap, n = 48, 64
    a = rng.integers(0, 4, (n, cap)).astype(np.uint8)
    b = a.copy()
    hit = rng.random(b.shape) < 0.15  # similar pairs, with substitutions
    b[hit] = rng.integers(0, 4, hit.sum())
    b[n // 2:] = rng.integers(0, 4, (n - n // 2, cap))  # and unrelated ones
    la = rng.integers(0, cap + 1, n)
    lb = np.clip(la + rng.integers(-3, 4, n), 0, cap)
    want = np.asarray(jtour._lcs_scores(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la, jnp.int32),
        jnp.asarray(lb, jnp.int32), cap))
    got = lcs.lcs_scores_plain(torch.from_numpy(a), torch.from_numpy(b),
                               torch.from_numpy(la), torch.from_numpy(lb),
                               cap)
    np.testing.assert_array_equal(want, got.numpy())
    for i in (0, 1, n - 1):
        assert got[i] == _lcs_reference(a[i, :la[i]], b[i, :lb[i]])


def _pinch_both(table, eg, aset, merge_level, k=K):
    """JAX (under the port's arc rule) and port pinch on the same graph;
    asserts equal results and returns the port's stats."""
    with pytest.MonkeyPatch.context() as mp:
        ruled = rule_on(mp)
        jeg, jas, jstats = jtour.pinch(eg, aset, k, merge_level)
    teg, tas, tstats = ttour.pinch(convert.to_torch(eg, "cpu"),
                                   convert.to_torch(aset, "cpu"), k,
                                   merge_level)
    for key in ("backtracked", "compared", "merged", "waves"):
        assert tstats[key] == jstats[key], key
    assert tstats["arcs_dropped"] == ruled.dropped
    np.testing.assert_array_equal(np.asarray(jeg.deleted), teg.deleted.numpy())
    np.testing.assert_array_equal(np.asarray(jeg.cvg), teg.cvg.numpy())
    assert tas.n == int(jas.n)
    for field in ("from_ed", "to_ed", "mult"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jas, field))[:tas.n],
            getattr(tas, field).numpy()[:tas.n], err_msg=field)
    return tstats


def test_snp_bubble_merged():
    rng = np.random.default_rng(21)
    t = unique_kmer_seq(rng, 200)
    table, eg, aset = build([t] * 9 + [snp_variant(t, 100)] * 3)
    stats = _pinch_both(table, eg, aset, 1)
    assert stats["merged"] == 1 and stats["productive"] == 1


def test_distinct_sequences_not_merged():
    rng = np.random.default_rng(22)
    p, q = unique_kmer_seq(rng, 80), unique_kmer_seq(rng, 80)
    t1 = p + unique_kmer_seq(rng, 40) + q
    t2 = p + unique_kmer_seq(rng, 60) + q
    table, eg, aset = build([t1] * 5 + [t2] * 5)
    assert _pinch_both(table, eg, aset, 1)["merged"] == 0


def test_multinode_bubble_merged():
    _t, _v, _spur, reads = _multinode_bubble_reads(np.random.default_rng(7))
    table, eg, aset = build(reads)
    assert _pinch_both(table, eg, aset, 1)["merged"] >= 1


def _unjoined(eg, aset):
    """The live arc rows (both edges live, mult > 0) whose from-edge does
    not end in the node its to-edge starts from."""
    dead = np.asarray(eg.deleted)
    fn, tn = np.asarray(eg.from_node), np.asarray(eg.to_node)
    n = int(aset.n)
    f, t, m = (np.asarray(x)[:n] for x in (aset.from_ed, aset.to_ed,
                                           aset.mult))
    live = (f >= 0) & (t >= 0) & (m > 0)
    live[live] &= ~dead[f[live]] & ~dead[t[live]]
    return [(int(a), int(b)) for a, b in zip(f[live], t[live])
            if tn[a] != fn[b]]


def test_multinode_bubble_joins_after_the_wave():
    """The majority branch is two edges, the minority one: the JAX wave
    remaps the minority edge's arcs onto its cover and leaves a row that
    skips a majority edge; the port's wave drops the bubble's own rows, so
    every row left joins, and the fork -> majority -> join path keeps its
    rows, forward and on the twin strand."""
    _t, _v, _spur, reads = _multinode_bubble_reads(np.random.default_rng(7))
    _table, eg, aset = build(reads)
    assert not _unjoined(eg, aset)
    jeg, jas, _ = jtour.pinch(eg, aset, K, 1)
    assert _unjoined(jeg, jas)  # the fault, in the JAX package
    teg, tas, stats = ttour.pinch(convert.to_torch(eg, "cpu"),
                                  convert.to_torch(aset, "cpu"), K, 1)
    assert stats["merged"] >= 1 and stats["arcs_dropped"] > 0
    assert not _unjoined(teg, tas)
    # every row between two edges that survive is kept
    before = set(zip(np.asarray(aset.from_ed)[:int(aset.n)].tolist(),
                     np.asarray(aset.to_ed)[:int(aset.n)].tolist()))
    after = set(zip(tas.from_ed.tolist(), tas.to_ed.tolist()))
    dead = teg.deleted.numpy()
    assert {(f, t) for f, t in before if not dead[f] and not dead[t]} <= \
        after


@pytest.mark.parametrize("level", [1, 2, 3])
def test_multinode_bubble_maxnodelength(level):
    """The majority side of this bubble is five edges: refused at -M 1
    (MAXNODELENGTH 3), pinched at -M 2 (9) and -M 3 (30)."""
    rng = np.random.default_rng(11)
    t = unique_kmer_seq(rng, 400)
    p, m, s = t[:100], t[100:300], t[300:]
    v_m = m
    for pos in (60, 70, 80, 90):
        v_m = snp_variant(v_m, pos)
    reads = [t] * 9 + [p + v_m + s] * 3
    for off in (48, 58, 68, 78):
        reads += [m[off:off + K] + unique_kmer_seq(rng, 40)] * 5
    table, eg, aset = build(reads)
    merged = _pinch_both(table, eg, aset, level)["merged"]
    assert (merged >= 1) == (level >= 2)


def _many_bubbles(n_bub, indel_every=0, k=23):
    """One long transcript with n_bub SNP bubbles (majority 3x, minority
    1x: every candidate has the same coverage); every indel_every-th
    bubble is a 6-base insertion instead, which never merges."""
    rng = np.random.default_rng(99)
    spacing = 100
    t = "".join(rng.choice(list("ACGT"), size=n_bub * spacing + 200))
    v = list(t)
    for i in range(n_bub):
        pos = 100 + i * spacing
        if indel_every and i % indel_every == 0:
            v[pos] = v[pos] + "".join(rng.choice(list("ACGT"), size=6))
        else:
            v[pos] = "ACGT"[("ACGT".index(v[pos]) + 2) % 4]
    return build([t] * 3 + ["".join(v)], k=k)


def test_many_bubbles_multi_wave(monkeypatch):
    """More candidates than CAND_CAP: the overflow drains across waves.
    (Power-of-two JAX capacities only save recompiles.)"""
    monkeypatch.setattr(jd, "CAP_MODE", "pow2")
    table, eg, aset = _many_bubbles(3000)
    stats = _pinch_both(table, eg, aset, 1, k=23)
    assert stats["waves"] > 2 and stats["merged"] >= 2970


def test_equal_coverage_candidate_order(monkeypatch):
    """Hundreds of candidates of one coverage, in chunks of 32, with
    never-merging ones among them: which candidates share a chunk, and
    so the wave count and the retired chunks, follow the arc row order
    of equal-coverage candidates."""
    monkeypatch.setattr(jd, "CAP_MODE", "pow2")
    monkeypatch.setattr(jtour, "CAND_CAP", 32)
    monkeypatch.setattr(ttour, "CAND_CAP", 32)
    table, eg, aset = _many_bubbles(300, indel_every=3)
    stats = _pinch_both(table, eg, aset, 1, k=23)
    assert stats["productive"] < stats["waves"]  # chunks were retired
    assert 195 <= stats["merged"] <= 200


def test_bubble_pinch_entry_point():
    rng = np.random.default_rng(23)
    t = unique_kmer_seq(rng, 200)
    table, eg, aset = build([t] * 9 + [snp_variant(t, 100)] * 3)
    teg, tas, stats = tbubbles.bubble_pinch(
        convert.to_torch(eg, "cpu"), convert.to_torch(aset, "cpu"),
        convert.to_torch(table, "cpu"), K, 1)
    assert stats["merged"] == 1 and int((~teg.deleted[:teg.n_edges]).sum()) == 6
    same = tbubbles.bubble_pinch(teg, tas, None, K, 0)
    assert same[0] is teg and same[2] == {}
