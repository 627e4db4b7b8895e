"""The 2-bit packed read upload of the port (ops/readpack.py and its
callers in ops/dictionary.py) against the JAX package's: the same
batches, made from a numpy seed; tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soapdenovo_trans_tpu.ops import dictionary as jdict
from soapdenovo_trans_tpu.ops import readpack as jreadpack
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.ops import dictionary as tdict
from soapdenovo_trans_tpu_torch.ops import readpack as treadpack
from soapdenovo_trans_tpu_torch.utils import profiling

K = 23


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def batch(seed, r, l, n_share):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(r, l)).astype(np.uint8)
    codes[rng.random((r, l)) < n_share] = 4
    return codes


@pytest.fixture(params=["native", "numpy"])
def packer(request, monkeypatch):
    """Both packers of ``pack_reads``: the native one where it is built,
    and the numpy formulation (taken when the library is missing)."""
    if request.param == "numpy":
        monkeypatch.setattr(treadpack.native, "available", lambda: False)
    return request.param


def unpack(pr):
    return treadpack.unpack_reads(torch.from_numpy(pr.data),
                                  torch.from_numpy(pr.n_flat), pr.l).numpy()


@pytest.mark.parametrize("l", [36, 37, 100])  # 37: a ragged last byte
def test_pack_matches_jax_and_round_trips(l, packer):
    codes = batch(l, 64, l, 0.001)
    codes[0, 0] = codes[-1, -1] = 4  # an N in the first and last slot
    want = jreadpack.pack_reads(codes)
    got = treadpack.pack_reads(codes)
    assert got.l == want.l == l
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.n_flat, want.n_flat)
    assert got.n_flat.shape[0] == treadpack.n_cap_for(64, l) == \
        jreadpack.n_cap_for(64, l)
    np.testing.assert_array_equal(unpack(got), codes)
    np.testing.assert_array_equal(
        unpack(got), np.asarray(jreadpack.unpack_reads(
            jnp.asarray(want.data), jnp.asarray(want.n_flat), l)))


def test_empty_batch_and_sideband_overflow(packer):
    empty = treadpack.pack_reads(np.zeros((0, 40), np.uint8))
    assert empty.data.shape == (0, 10)
    assert unpack(empty).shape == (0, 40)
    assert (empty.n_flat == 0).all()  # r*l == 0: every entry means "none"
    # more N bases than the sideband holds: not packed
    many = batch(5, 32, 40, 0.9)
    assert (many >= 4).sum() > treadpack.n_cap_for(32, 40)
    assert treadpack.pack_reads(many) is None
    assert jreadpack.pack_reads(many) is None
    # exactly at capacity it still packs
    full = np.zeros((1024, 1), np.uint8)
    full[:treadpack.n_cap_for(1024, 1)] = 4
    pr = treadpack.pack_reads(full)
    np.testing.assert_array_equal(unpack(pr), full)


@pytest.mark.parametrize("n_share", [0.002, 0.9])  # packed / raw upload
def test_sorted_run_from_host_reads_matches_jax(n_share):
    codes = batch(9, 48, 60, n_share)
    lens = np.random.default_rng(9).integers(K, 61, size=48).astype(np.int32)
    prepped = tdict.pack_host_reads(codes, lens)
    jprepped = jdict.pack_host_reads(codes, lens)
    assert prepped[0] == jprepped[0] == ("packed" if n_share < 0.5
                                         else "raw")
    for a, b in zip(prepped[1:], jprepped[1:]):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    dev = torch.device("cpu")
    got = tdict.sorted_run_from_prepped(tdict.put_prepped(prepped, dev), K)
    want = jdict.sorted_run_from_host_reads(codes, lens, K)
    n = int(want.n)
    assert int(got.n) == n
    got_np = convert.to_numpy(got)
    np.testing.assert_array_equal(got_np.rows[:n],
                                  np.asarray(want.rows)[:n])
    np.testing.assert_array_equal(got_np.count[:n],
                                  np.asarray(want.count)[:n])
    # and the packed upload builds what the raw upload builds
    raw = tdict.sorted_run_from_reads(torch.from_numpy(codes),
                                      torch.from_numpy(lens), K)
    again = tdict.sorted_run_from_host_reads(codes, lens, K, dev)
    assert torch.equal(again.rows, raw.rows)
    assert torch.equal(again.count, raw.count)


def test_stage_timings_table():
    t = profiling.StageTimings()
    assert t.timing_table() == ""
    with t.stage_timer("pregraph"):
        pass
    with pytest.raises(KeyError):
        with t.stage_timer("contig"):
            raise KeyError("x")  # a failed stage is still timed
    with t.stage_timer("pregraph"):
        pass
    lines = t.timing_table().splitlines()
    assert lines[0] == "stage timing:" and len(lines) == 4
    assert [x.split()[0] for x in lines[1:]] == ["pregraph", "contig",
                                                 "total"]
    t.reset()
    assert t.timing_table() == ""
