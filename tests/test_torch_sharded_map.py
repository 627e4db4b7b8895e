"""The mesh-resident map stage of the port (parallel/sharded_map.py)
against the JAX package's on its 8-device CPU mesh: the same contig
index and reads, made from a numpy seed, go through both; tolerance 0 on
every ReadPlacements field (group slots: the valid ones).  Then, port
only: every mesh size gives the dense placements."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from soapdenovo_trans_tpu.ops import bits as jbits
from soapdenovo_trans_tpu.parallel import sharded_map as jsm
from soapdenovo_trans_tpu.stages import map as jmap
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.parallel import sharded_map as tsm
from soapdenovo_trans_tpu_torch.parallel.mesh import Mesh
from soapdenovo_trans_tpu_torch.stages import map as tmap
from tests.test_map import K, assemble_contigs, pad, unique_kmer_seq

D = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fixture():
    """Two contigs and reads tiling them on both strands, one read
    below the vote threshold and one chimeric (the reads of the JAX
    package's own sharded map test)."""
    rng = np.random.default_rng(31)
    taken = set()
    t1 = unique_kmer_seq(rng, 300, taken=taken)
    t2 = unique_kmer_seq(rng, 250, taken=taken)
    table, ctg = assemble_contigs([t1, t2])
    index = jmap.build_contig_index(ctg, table, K)
    reads = []
    for t in (t1, t2):
        for i in range(0, len(t) - 50 + 1, 7):
            r = t[i:i + 50]
            reads.append(jbits.revcomp_str(r) if rng.random() < 0.5 else r)
    reads.append(t1[10:27])            # below the multi threshold
    reads.append(t1[-40:] + t2[:40])   # chimeric: two contigs
    padded, lens = pad(reads)
    return index, np.array(padded), np.array(lens)


def assert_placements_equal(got, want):
    va, vb = np.asarray(want.g_valid), got.g_valid.numpy()
    np.testing.assert_array_equal(vb, va)
    assert va.sum() > 0
    for f in tmap.ReadPlacements._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f.startswith("g_"):
            a, b = a[va], b[vb]
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_shard_index_and_map_reads_match_jax(fixture):
    index, codes, lens = fixture
    jmesh = JMesh(np.array(jax.devices()[:D]), (jsm.AXIS,))
    jsidx = jsm.shard_index(jmesh, index, K)
    want = jsm.map_reads_sharded(jmesh, jsidx, codes, lens, K, map_len=32)

    mesh = Mesh(["cpu"] * D)
    sidx = tsm.shard_index(mesh, convert.to_torch(index, "cpu"), K)
    n = np.asarray(jsidx.n)
    assert sidx.n == n.tolist() and sidx.keys[0].shape[0] == n.max()
    got_idx = convert.sharded_to_numpy(sidx)
    for f in ("keys", "payload"):
        for s in range(D):
            np.testing.assert_array_equal(
                got_idx[f][s, :n[s]], np.asarray(getattr(jsidx, f))[s, :n[s]],
                err_msg=f"{f} shard {s}")
    assert got_idx["deleted"].dtype == np.int32 and \
        not got_idx["deleted"].any()

    got = tsm.map_reads_sharded(mesh, sidx, codes, lens, K, map_len=32)
    assert got.ctg.shape[0] == codes.shape[0]
    assert_placements_equal(got, want)
    # the JAX package's index, converted shard by shard, serves as well
    conv = convert.sharded_to_torch(
        jsm.ShardedContigIndex(*(np.asarray(x) for x in jsidx)), mesh)
    assert_placements_equal(
        tsm.map_reads_sharded(mesh, conv, codes, lens, K, map_len=32), want)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_map_equals_dense_at_every_mesh_size(d, fixture):
    index, codes, lens = fixture
    codes, lens = codes[1:], lens[1:]  # 67 rows: every d > 1 pads
    tindex = convert.to_torch(index, "cpu")
    want = tmap.map_reads(torch.from_numpy(codes), torch.from_numpy(lens),
                          tindex, K, map_len=32)
    mesh = Mesh(["cpu"] * d)
    got = tsm.map_reads_sharded(mesh, tsm.shard_index(mesh, tindex, K),
                                codes, lens, K, map_len=32)
    assert (want.ctg >= 0).sum() > 60 and want.footprint.any()
    for f in tmap.ReadPlacements._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_empty_index_maps_nothing():
    mesh = Mesh(["cpu"] * 2)
    empty = tmap.ContigIndex(
        torch.full((1, 1), 0xFFFFFFFF, dtype=torch.int64),
        torch.full((1,), -1), torch.full((1,), -1),
        torch.zeros(1, dtype=torch.bool), 0,
        torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64))
    sidx = tsm.shard_index(mesh, empty, K)
    assert sidx.n == [0, 0]
    codes = np.random.default_rng(0).integers(0, 4, (5, 40)).astype(np.uint8)
    pl = tsm.map_reads_sharded(mesh, sidx, codes, np.full(5, 40, np.int32), K)
    assert (pl.ctg == -1).all() and not pl.g_valid.any()
