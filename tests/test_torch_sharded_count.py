"""Sharded counting of the port (parallel/sharded_count.py and the mesh
functions of stages/pregraph.py) against the JAX package's on its
8-device CPU mesh: the same reads, made from a numpy seed, go through
both; tolerance 0, on the live prefix of every shard, counts per key.
Then, port only: every mesh size gives the dense table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from soapdenovo_trans_tpu.parallel import sharded_count as jsc
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.ops import dictionary as td
from soapdenovo_trans_tpu_torch.parallel import sharded_count as tsc
from soapdenovo_trans_tpu_torch.parallel.mesh import Mesh
from soapdenovo_trans_tpu_torch.stages import pregraph as tpg

K = 23
D = 8
BATCH = 16
READ_LEN = 60


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_reads(rng, n_reads, read_len):
    seqs = rng.integers(0, 4, size=(n_reads, read_len)).astype(np.uint8)
    lens = rng.integers(K, read_len + 1, size=n_reads).astype(np.int32)
    seqs[rng.random((n_reads, read_len)) < 0.01] = 4  # some Ns
    return seqs, lens


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:D]), (jsc.AXIS,))


@pytest.fixture(scope="module")
def batches():
    """Two read batches that share reads, so the merge sums counts."""
    rng = np.random.default_rng(7)
    a = make_reads(rng, D * BATCH, READ_LEN)
    b = make_reads(rng, D * BATCH, READ_LEN)
    b[0][::3], b[1][::3] = a[0][::3], a[1][::3]
    return a, b


@pytest.fixture(scope="module")
def jax_counts(jmesh, batches):
    """The JAX package's ShardedPacked of each batch, as numpy."""
    run = jsc.make_sharded_counter(jmesh, K, BATCH, READ_LEN)
    sh2 = NamedSharding(jmesh, P(jsc.AXIS, None))
    sh1 = NamedSharding(jmesh, P(jsc.AXIS))
    out = []
    for seqs, lens in batches:
        sp = run(jax.device_put(jnp.asarray(seqs), sh2),
                 jax.device_put(jnp.asarray(lens), sh1))
        assert int(jnp.sum(sp.dropped)) == 0
        out.append(sp)
    return out


def port_count(mesh, seqs, lens):
    return tsc.count_step(mesh, mesh.split_rows(seqs), mesh.split_rows(lens),
                          K)


def assert_live_equal(port_sharded, jax_nt, fields):
    """Every shard's live prefix [0, n[s]) equals the JAX package's."""
    n = np.asarray(jax_nt.n)
    assert list(port_sharded.n) == n.tolist()
    got = convert.sharded_to_numpy(port_sharded)
    for f in fields:
        want = np.asarray(getattr(jax_nt, f))
        for s in range(n.shape[0]):
            np.testing.assert_array_equal(
                got[f][s, :n[s]], want[s, :n[s]], err_msg=f"{f} shard {s}")


def test_count_step_matches_jax(jax_counts, batches):
    mesh = Mesh(["cpu"] * D)
    for sp, (seqs, lens) in zip(jax_counts, batches):
        got = port_count(mesh, seqs, lens)
        assert_live_equal(got, sp, ("rows", "count"))
        assert sum(got.n) > 1000
    assert mesh.exchanges == 2  # one exchange a batch, no retry


def test_merger_matches_jax(jmesh, jax_counts, batches):
    want = jsc.make_sharded_merger(jmesh)(*jax_counts)
    mesh = Mesh(["cpu"] * D)
    got = tsc.merge_sharded(mesh, *(port_count(mesh, *b) for b in batches))
    assert_live_equal(got, want, ("rows", "count"))
    assert max(int(c.max()) for c in got.count) >= 2  # shared rows summed


def test_finalizer_and_gather_match_jax(jmesh, jax_counts, batches):
    merged = jsc.make_sharded_merger(jmesh)(*jax_counts)
    want = jsc.make_sharded_finalizer(jmesh, K)(merged)
    mesh = Mesh(["cpu"] * D)
    got = tsc.finalize_sharded(mesh, tsc.merge_sharded(
        mesh, *(port_count(mesh, *b) for b in batches)), K)
    fields = ("keys", "count", "l_cov", "r_cov")
    assert_live_equal(got, want, fields)
    assert got.cap == max(got.n)  # exact: the largest shard's rows

    want_t = jsc.gather_to_table(want)
    got_t = tsc.gather_to_table(mesh, got)
    n = int(want_t.n)
    assert got_t.n == n and got_t.capacity == n
    got_np = convert.to_numpy(got_t)
    for f in fields:
        np.testing.assert_array_equal(
            getattr(got_np, f), np.asarray(getattr(want_t, f))[:n], f)
    assert not got_t.deleted.any()


def test_convert_round_trip_and_dropped_zeros(jax_counts):
    """JAX (D, cap, ...) arrays -> per-shard lists -> back: the live
    prefixes survive, the padding is sentinels and zeros, ``dropped`` is
    filled with zeros."""
    sp = jax_counts[0]
    mesh = Mesh(["cpu"] * D)
    port = convert.sharded_to_torch(sp, mesh)
    assert isinstance(port, tsc.ShardedPacked)
    assert "dropped" not in port._fields
    n = np.asarray(sp.n)
    assert [x.shape[0] for x in port.rows] == n.tolist()
    back = convert.sharded_to_numpy(port, jsc.ShardedPacked)
    assert back.dropped.tolist() == [0] * D
    cap = int(n.max())
    assert back.rows.shape[:2] == (D, cap) and back.rows.dtype == np.uint32
    np.testing.assert_array_equal(back.rows, np.asarray(sp.rows)[:, :cap])
    np.testing.assert_array_equal(back.count, np.asarray(sp.count)[:, :cap])
    with pytest.raises(ValueError):
        convert.sharded_to_torch(sp, Mesh(["cpu"] * 4))


# ---- port only --------------------------------------------------------


def read_batches(seed=11, n=5, reads=50, read_len=48):
    rng = np.random.default_rng(seed)
    pool = make_reads(rng, 40, read_len)  # reads recur across batches
    out = []
    for _ in range(n):
        pick = rng.integers(0, 40, size=reads)
        out.append((pool[0][pick], pool[1][pick], 0))
    return out


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_count_equals_dense_at_every_mesh_size(d):
    """count_reads on a mesh (five batches through the merge forest,
    50 reads each: not a multiple of 4 or 8, so the last shards get
    padding rows) gives the dense table."""
    dev = torch.device("cpu")
    want = tpg.count_reads(iter(read_batches()), K, dev)
    got = tpg.count_reads(iter(read_batches()), K, dev,
                          mesh=Mesh(["cpu"] * d))
    assert got.n == want.n > 0
    for f in ("keys", "count", "l_cov", "r_cov", "deleted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_sharded_count_refuses_no_reads_and_low_cap():
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="no reads"):
        tpg.count_reads(iter([]), K, torch.device("cpu"), mesh=mesh)
    st = tpg._count_reads_sharded(iter(read_batches(n=1)), K, mesh)
    wide = tsc.with_cap(st, st.cap + 5)
    assert wide.cap == st.cap + 5 and wide.n == st.n
    assert (wide.keys[0][st.cap:] == td.SENTINEL).all()
    with pytest.raises(ValueError):
        tsc.with_cap(st, max(st.n) - 1)
    with pytest.raises(TypeError):
        tsc.gather_to_table(mesh, tsc.ShardedPacked([], [], []))


def test_merge_forest_merges_equal_ranks():
    """Binary-counter accumulation: 5 inserts -> levels 1 and 4."""
    forest = tpg._MergeForest(lambda a, b: a + b)
    for i in range(5):
        forest.insert([i])
    assert [None if x is None else len(x) for x in forest.levels] == \
        [1, None, 4]
    assert sorted(forest.finish()) == [0, 1, 2, 3, 4]
    assert tpg._MergeForest(lambda a, b: a + b).finish() is None
