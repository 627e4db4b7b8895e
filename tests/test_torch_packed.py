"""Port parity: the ``PackedTable`` path of
``soapdenovo_trans_tpu_torch.ops.dictionary`` (``build_packed``,
``build_packed_from_reads[_many]``, ``merge_packed``, ``finalize``,
``merge_finalize``, ``build``) against the JAX ops/dictionary at K = 23
(two-lane rows: on the CPU the JAX package merges by concat + sort and
the port by its kernel's plain version) and K = 31 (three-lane rows:
both sort).  Live prefixes [0, n) are compared, since the JAX package
pads capacities and the port keeps them exact.  Integer results:
tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu.ops import kmer as jkmer
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.kernels import merge_path
from soapdenovo_trans_tpu_torch.ops import dictionary as td
from soapdenovo_trans_tpu_torch.ops import kmer as tkmer

from .test_torch_dictionary import _np

TABLE_FIELDS = ("keys", "count", "l_cov", "r_cov", "deleted")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _reads(seed, r=64, l=60):
    """Reads drawn from ONE small pool of sequences whatever the seed,
    so that k-mers repeat within a batch and between batches."""
    pool = np.random.default_rng(0).integers(
        0, 4, size=(8, l + 40)).astype(np.uint8)
    rng = np.random.default_rng(seed)
    codes = pool[rng.integers(0, 8, r)[:, None],
                 rng.integers(0, 40, r)[:, None] + np.arange(l)]
    codes[rng.random((r, l)) < 0.01] = 4
    lengths = np.full(r, l, np.int32)
    lengths[-2:] = l // 2
    return codes, lengths


def _packed_pair(seed, k):
    codes, lengths = _reads(seed)
    return (jd.build_packed_from_reads(jnp.asarray(codes),
                                       jnp.asarray(lengths), k),
            td.build_packed_from_reads(torch.from_numpy(codes),
                                       torch.from_numpy(lengths), k))


def _assert_packed_equal(jp, tp):
    n = int(jp.n)
    assert tp.n == n and tp.capacity == max(n, 1)
    np.testing.assert_array_equal(_np(jp.rows)[:n], tp.rows[:n].numpy())
    np.testing.assert_array_equal(_np(jp.count)[:n], tp.count[:n].numpy())
    assert tp.rows.dtype == torch.int64 and tp.count.dtype == torch.int32


def _assert_table_equal(jt, tt):
    n = int(jt.n)
    assert tt.n == n and n > 0
    for field in TABLE_FIELDS:
        np.testing.assert_array_equal(
            _np(getattr(jt, field))[:n],
            getattr(tt, field)[:n].numpy().astype(np.int64), err_msg=field)


def _counts_per_key(table):
    n = int(table.n)
    return dict(zip(map(tuple, _np(table.keys)[:n].tolist()),
                    _np(table.count)[:n].tolist()))


@pytest.mark.parametrize("k", [23, 31])
def test_build_packed_matches_jax(k):
    jp, tp = _packed_pair(1, k)
    _assert_packed_equal(jp, tp)
    assert tp.rows.shape[1] == td.packed_width_k(k) == (2 if k == 23 else 3)
    # through the stream, and carried across by convert
    codes, lengths = _reads(1)
    stream = tkmer.chop_reads(torch.from_numpy(codes),
                              torch.from_numpy(lengths), k)
    _assert_packed_equal(jp, td.build_packed(stream, k))
    n = tp.n
    carried = convert.to_torch(
        jd.PackedTable(np.asarray(jp.rows)[:n], np.asarray(jp.count)[:n],
                       np.int32(n)), "cpu")
    assert torch.equal(carried.rows, tp.rows) and carried.n == n
    back = convert.to_numpy(tp, jd.PackedTable)
    assert back.rows.dtype == np.uint32 and back.count.dtype == np.int32
    np.testing.assert_array_equal(back.rows, np.asarray(jp.rows)[:n])


@pytest.mark.parametrize("k", [23, 31])
def test_build_packed_many_matches_single(k):
    batches = [_reads(seed) for seed in (4, 5, 6)]
    many = td.build_packed_from_reads_many(
        [(torch.from_numpy(c), torch.from_numpy(l)) for c, l in batches], k)
    jmany = jd.build_packed_from_reads_many(
        [(jnp.asarray(c), jnp.asarray(l)) for c, l in batches], k)
    assert len(many) == 3
    for jp, tp in zip(jmany, many):
        _assert_packed_equal(jp, tp)


@pytest.mark.parametrize("k", [23, 31])
def test_merge_packed_matches_jax(k):
    ja, ta = _packed_pair(1, k)
    jb, tb = _packed_pair(2, k)
    jm, tm = jd.merge_packed(ja, jb), td.merge_packed(ta, tb)
    _assert_packed_equal(jm, tm)
    assert tm.n < ta.n + tb.n  # the two batches share rows
    assert int(tm.count.sum()) == int(ta.count.sum()) + int(tb.count.sum())
    plain = td.merge_packed_plain(ta, tb)
    assert torch.equal(plain.rows, tm.rows) and \
        torch.equal(plain.count, tm.count) and plain.n == tm.n
    # a third batch on top, and the order of merging does not matter
    jc, tc = _packed_pair(3, k)
    _assert_packed_equal(jd.merge_packed(jm, jc), td.merge_packed(tm, tc))
    other = td.merge_packed(ta, td.merge_packed(tb, tc))
    assert torch.equal(other.rows, td.merge_packed(tm, tc).rows)


@pytest.mark.parametrize("k", [23, 31])
def test_merge_with_empty_table(k):
    _, ta = _packed_pair(1, k)
    codes = np.full((2, 60), 4, np.uint8)  # N only: no valid window
    empty = td.build_packed_from_reads(
        torch.from_numpy(codes), torch.full((2,), 60, dtype=torch.int32), k)
    assert empty.n == 0 and empty.capacity == 1
    assert (empty.rows == td.SENTINEL).all()
    for merged in (td.merge_packed(ta, empty), td.merge_packed(empty, ta)):
        assert merged.n == ta.n and torch.equal(merged.rows, ta.rows)
        assert torch.equal(merged.count, ta.count)


@pytest.mark.parametrize("k", [23, 31])
def test_finalize_and_build_match_jax(k):
    jp, tp = _packed_pair(7, k)
    _assert_table_equal(jd.finalize(jp, k), td.finalize(tp, k))
    codes, lengths = _reads(7)
    js = jkmer.chop_reads(jnp.asarray(codes), jnp.asarray(lengths), k)
    ts = tkmer.chop_reads(torch.from_numpy(codes), torch.from_numpy(lengths),
                          k)
    _assert_table_equal(jd.build(js, k), td.build(ts, k))


@pytest.mark.parametrize("k", [23, 31])
def test_merge_finalize_matches_jax_and_run_path(k):
    ja, ta = _packed_pair(8, k)
    jb, tb = _packed_pair(9, k)
    want = jd.merge_finalize(ja, jb, k)
    got = td.merge_finalize(ta, tb, k)
    _assert_table_equal(want, got)
    assert _counts_per_key(want) == _counts_per_key(
        convert.to_numpy(got, jd.KmerTable))
    # = finalize(merge_packed(...)) and = its plain version
    for other in (td.finalize(td.merge_packed(ta, tb), k),
                  td.merge_finalize_plain(ta, tb, k)):
        for field in TABLE_FIELDS:
            assert torch.equal(getattr(other, field), getattr(got, field))
    # = the run path on the same reads
    runs = [td.sorted_run_from_reads(torch.from_numpy(c),
                                     torch.from_numpy(l), k)
            for c, l in (_reads(8), _reads(9))]
    run_table = td.finalize_run(td.merge_runs(*runs), k)
    for field in TABLE_FIELDS:
        assert torch.equal(getattr(run_table, field), getattr(got, field))


def test_two_lane_merges_go_through_the_kernel_wrapper(monkeypatch):
    """K = 23: merge_packed and merge_finalize call
    ``merge_path.merge_sorted_rows`` once each (on a CPU tensor it takes
    its plain version and counts no launch); K = 31 never calls it."""
    calls = []
    wrapper = merge_path.merge_sorted_rows
    monkeypatch.setattr(merge_path, "merge_sorted_rows",
                        lambda *a: calls.append(a[0].shape) or wrapper(*a))
    before = merge_path.LAUNCHES
    for k, want in ((23, 2), (31, 0)):
        calls.clear()
        (_, ta), (_, tb) = _packed_pair(1, k), _packed_pair(2, k)
        td.merge_packed(ta, tb)
        td.merge_finalize(ta, tb, k)
        td.merge_packed_plain(ta, tb)
        td.merge_finalize_plain(ta, tb, k)
        assert len(calls) == want
    assert merge_path.LAUNCHES == before
