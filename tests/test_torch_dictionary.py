"""Port parity: the run path of soapdenovo_trans_tpu_torch.ops.dictionary
vs the JAX ops/dictionary (CPU: the JAX merges take concat + sort, the
port's its plain merge).  Live prefixes [0, n) are compared: the JAX
package pads capacities, the port keeps them exact.  Counts of equal
rows after a merge are compared as sums per row."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu.ops import kmer as jkmer
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.ops import dictionary as td
from soapdenovo_trans_tpu_torch.ops import kmer as tkmer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reads(seed, r=64, l=60):
    """Reads from a small pool of sequences, so k-mers repeat."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 4, size=(8, l + 40)).astype(np.uint8)
    starts = rng.integers(0, 40, r)
    codes = pool[rng.integers(0, 8, r)[:, None],
                 starts[:, None] + np.arange(l)]
    codes[rng.random((r, l)) < 0.01] = 4
    lengths = np.full(r, l, np.int32)
    lengths[-2:] = l // 2
    return codes, lengths


def _np(x):
    return np.asarray(x).astype(np.int64)


def _run_pair(seed, k):
    codes, lengths = _reads(seed)
    j = jd.sorted_run_from_reads(jnp.asarray(codes), jnp.asarray(lengths), k)
    t = td.sorted_run_from_reads(torch.from_numpy(codes),
                                 torch.from_numpy(lengths), k)
    return j, t


def _row_sums(rows, count, n):
    out = {}
    for row, c in zip(map(tuple, rows[:n].tolist()), count[:n].tolist()):
        out[row] = out.get(row, 0) + c
    return out


@pytest.mark.parametrize("k", [13, 23, 31])
def test_pack_unpack_matches_jax(k):
    codes, lengths = _reads(k)
    js = jkmer.chop_reads(jnp.asarray(codes), jnp.asarray(lengths), k)
    ts = tkmer.chop_reads(torch.from_numpy(codes), torch.from_numpy(lengths),
                          k)
    jp = jd.pack_stream(js.kmers, js.prev, js.next, js.valid, k)
    tp = td.pack_stream(ts.kmers, ts.prev, ts.next, ts.valid, k)
    np.testing.assert_array_equal(_np(jp), tp.numpy())
    for want, got in zip(jd.unpack_rows(jp, k), td.unpack_rows(tp, k)):
        np.testing.assert_array_equal(_np(want), got.numpy().astype(np.int64))


@pytest.mark.parametrize("k", [23, 31])
def test_sorted_run_and_merge_match_jax(k):
    ja, ta = _run_pair(1, k)
    jb, tb = _run_pair(2, k)
    assert int(ja.n) == int(ta.n)
    np.testing.assert_array_equal(_np(ja.rows), ta.rows.numpy())
    np.testing.assert_array_equal(_np(ja.count), ta.count.numpy())

    jm = jd.merge_runs(ja, jb)
    tm = td.merge_runs(ta, tb)
    n = int(jm.n)
    assert int(tm.n) == n and tm.capacity == ta.capacity + tb.capacity
    np.testing.assert_array_equal(_np(jm.rows)[:n], tm.rows[:n].numpy())
    assert (tm.rows[n:] == td.SENTINEL).all()
    assert _row_sums(_np(jm.rows), _np(jm.count), n) == \
        _row_sums(tm.rows.numpy(), tm.count.numpy(), n)

    jc, tc = jd.collapse_run(jm), td.collapse_run(tm)
    n = int(jc.n)
    assert int(tc.n) == n
    np.testing.assert_array_equal(_np(jc.rows)[:n], tc.rows[:n].numpy())
    np.testing.assert_array_equal(_np(jc.count)[:n], tc.count[:n].numpy())


@pytest.mark.parametrize("k", [23, 31])
def test_accumulate_finalize_matches_jax(k):
    jacc, tacc = jd.RunAccumulator(), td.RunAccumulator()
    for seed in range(5):
        j, t = _run_pair(10 + seed, k)
        jacc.insert(j)
        tacc.insert(t)
    jt = jd.finalize_run(jacc.finish(), k)
    tt = td.finalize_run(tacc.finish(), k)
    assert tt.n == int(jt.n)
    n = tt.n
    for field in ("keys", "count", "l_cov", "r_cov", "deleted"):
        np.testing.assert_array_equal(
            _np(getattr(jt, field))[:n],
            getattr(tt, field)[:n].numpy().astype(np.int64), err_msg=field)
    back = convert.to_numpy(tt, jd.KmerTable)
    assert back.keys.dtype == np.uint32 and back.count.dtype == np.int32
    np.testing.assert_array_equal(back.keys[:n], np.asarray(jt.keys)[:n])


def test_collapse_folds_when_bound_reached():
    acc = td.RunAccumulator(collapse_rows=1)
    _, t = _run_pair(3, 23)
    acc.insert(t)
    assert len(acc.runs) == 1
    base = acc.runs[0]
    assert base.capacity == int(base.n) < t.capacity  # compacted
    assert int(base.count.sum()) == int(t.n)          # nothing lost


@pytest.mark.parametrize("k", [13, 23, 33])
def test_lookup_matches_jax(k):
    codes, lengths = _reads(k)
    js = jkmer.chop_reads(jnp.asarray(codes), jnp.asarray(lengths), k)
    jt = jd.finalize_run(jd.sorted_run_from_reads(
        jnp.asarray(codes), jnp.asarray(lengths), k), k)
    table = convert.to_torch(jt, "cpu")
    other, olen = _reads(k + 100)  # mostly misses
    jq = jnp.concatenate([js.kmers, jkmer.chop_reads(
        jnp.asarray(other), jnp.asarray(olen), k).kmers])
    want = np.asarray(jd.lookup(jt.keys, jq))
    got = td.lookup(table.keys, torch.from_numpy(_np(jq)))
    np.testing.assert_array_equal(want, got.numpy())
    assert (want >= 0).any() and (want < 0).any()
