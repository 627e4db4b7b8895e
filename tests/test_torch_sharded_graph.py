"""The routed primitives of the port (parallel/sharded_graph.py over
parallel/mesh.py) against the JAX package's on its 8-device CPU mesh:
the same inputs, made from a numpy seed, go through both; tolerance 0
(integers).  Then, port only: the same primitives at D = 1, 2, 4, 8
against plain numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from soapdenovo_trans_tpu.ops import bits as jbits
from soapdenovo_trans_tpu.ops import dictionary as jdict
from soapdenovo_trans_tpu.ops import ranking as jranking
from soapdenovo_trans_tpu.parallel import sharded_count as jsc
from soapdenovo_trans_tpu.parallel import sharded_graph as jsg
from soapdenovo_trans_tpu_torch.ops import ranking as tranking
from soapdenovo_trans_tpu_torch.parallel import sharded_count as tsc
from soapdenovo_trans_tpu_torch.parallel import sharded_graph as tsg
from soapdenovo_trans_tpu_torch.parallel.mesh import Mesh

D = 8
K = 15


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    assert len(devs) >= D, "conftest must force 8 CPU devices"
    return JMesh(np.array(devs[:D]), (jsg.AXIS,))


def cpu_mesh(d=D):
    return Mesh(["cpu"] * d)


def shards(x, dtype=torch.int64):
    """(D, ...) numpy -> the port's list of per-shard tensors."""
    return [torch.from_numpy(np.ascontiguousarray(s)).to(dtype) for s in x]


def stacked(xs):
    return np.stack([x.numpy() for x in xs])


def test_mesh_all_to_all_is_ragged_and_counts_bytes():
    mesh = cpu_mesh(3)
    send = [[torch.arange(j * 10 + s, dtype=torch.int64)
             for s in range(3)] for j in range(3)]
    recv = mesh.all_to_all(send)
    for s in range(3):
        for j in range(3):
            assert recv[s][j].shape[0] == j * 10 + s
    moved = sum(8 * (j * 10 + s) for j in range(3) for s in range(3)
                if j != s)
    assert (mesh.exchanges, mesh.exchange_bytes) == (1, moved)
    with pytest.raises(ValueError):
        Mesh([])


def test_routed_gather_matches_jax(jmesh):
    rng = np.random.default_rng(101)
    cap, m = 64, 96
    x = rng.integers(0, 1000, size=(D, cap, 2)).astype(np.int32)
    idx = rng.integers(-2, D * cap, size=(D, m)).astype(np.int32)
    want = np.asarray(jsg.Router(jmesh, cap).gather(
        jnp.asarray(x), jnp.asarray(idx), n_fields=2))
    got = tsg.Router(cpu_mesh(), cap).gather(shards(x), shards(idx))
    np.testing.assert_array_equal(stacked(got), want)


def test_routed_gather_hotspot_matches_jax(jmesh):
    """Every query targets one row of shard 0: the JAX package retries
    with a doubled bucket, the port's buckets are exact."""
    rng = np.random.default_rng(102)
    cap, m = 32, 64
    x = rng.integers(0, 99, size=(D, cap, 1)).astype(np.int32)
    idx = np.full((D, m), 7, np.int32)
    want = np.asarray(jsg.Router(jmesh, cap).gather(
        jnp.asarray(x), jnp.asarray(idx)))
    mesh = cpu_mesh()
    got = tsg.Router(mesh, cap).gather(shards(x), shards(idx))
    np.testing.assert_array_equal(stacked(got), want)
    assert (stacked(got)[..., 0] == x[0, 7, 0]).all()
    assert mesh.exchanges == 2  # the request and the answer, no retry


@pytest.mark.parametrize("op", ["add", "max", "or"])
def test_routed_scatter_matches_jax(jmesh, op):
    rng = np.random.default_rng(103)
    cap, m = 48, 80
    idx = rng.integers(-2, D * cap, size=(D, m)).astype(np.int32)
    vals = rng.integers(0, 1000, size=(D, m, 1)).astype(np.int32)
    want = np.asarray(jsg.Router(jmesh, cap).scatter(
        jnp.asarray(idx), jnp.asarray(vals), op=op))
    got = tsg.Router(cpu_mesh(), cap).scatter(shards(idx), shards(vals),
                                             op=op)
    np.testing.assert_array_equal(stacked(got), want)
    if op == "max":
        assert int(jsg._NEG) == tsg._NEG and (want == tsg._NEG).any()


def _random_sharded_table(rng, n_keys, d=D):
    """Random canonical k-mer keys split by the counting split points:
    (keys (n, W), shard keys (d, cap, W) uint32, n (d,), global row of
    each key, cap)."""
    raw = rng.integers(0, 2 ** (2 * K), size=4 * n_keys, dtype=np.uint64)
    w = jbits.words_for_k(K)
    km = np.zeros((raw.shape[0], w), np.uint32)
    km[:, -1] = (raw & 0xFFFFFFFF).astype(np.uint32)
    if w > 1:
        km[:, -2] = (raw >> np.uint64(32)).astype(np.uint32) & \
            ((1 << (2 * K - 32)) - 1)
    can, _ = jbits.canonical(jnp.asarray(km), K)
    can = np.unique(np.asarray(can), axis=0)[:n_keys]
    bounds = jsc._owner_boundaries(K, d)
    owner = np.searchsorted(bounds, can[:, 0], side="right")
    cap = jdict.round_up(max(np.bincount(owner, minlength=d).max(), 1))
    keys = np.full((d, cap, w), 0xFFFFFFFF, np.uint32)
    n = np.zeros(d, np.int32)
    gid = np.zeros(can.shape[0], np.int32)
    for i, (o, row) in enumerate(zip(owner, can)):
        keys[o, n[o]] = row
        gid[i] = o * cap + n[o]
        n[o] += 1
    return can, keys, n, gid, cap


def test_routed_lookup_matches_jax_with_deleted_rows(jmesh):
    rng = np.random.default_rng(104)
    can, keys, n, gid, cap = _random_sharded_table(rng, 500)
    w = can.shape[1]
    m = 128
    deleted = np.zeros((D, cap), np.int32)
    for g in gid[::3]:  # every third key is dead
        deleted[g // cap, g % cap] = 1
    pick = rng.integers(0, can.shape[0], size=D * m // 2)
    fake = rng.integers(0, 2 ** 16, size=(D * m - pick.shape[0] - 5, w)
                        ).astype(np.uint32)
    fake[:, 0] |= 1 << 29  # beyond the canonical top-word range
    none = np.full((5, w), 0xFFFFFFFF, np.uint32)  # sentinel queries
    queries = rng.permutation(np.concatenate([can[pick], fake, none])
                              ).reshape(D, m, w)
    want = np.asarray(jsg.Router(jmesh, cap).lookup(
        jnp.asarray(keys), jnp.asarray(n), jnp.asarray(deleted),
        jnp.asarray(queries), k=K))
    got = tsg.Router(cpu_mesh(), cap).lookup(
        shards(keys), n.tolist(), shards(deleted, torch.bool),
        shards(queries), k=K)
    np.testing.assert_array_equal(stacked(got), want)
    assert (want >= 0).any() and (want < 0).any()


def _chains(rng, n, odd_and_even_cycles=True):
    """A chain forest with an even and an odd cycle."""
    prev = np.full(n, -1, np.int32)
    exists = np.zeros(n, bool)
    perm = rng.permutation(n)
    pos = 0
    for _ in range(40):
        ln = int(rng.integers(1, 12))
        chain = perm[pos:pos + ln]
        pos += ln
        exists[chain] = True
        for a, b in zip(chain[:-1], chain[1:]):
            prev[b] = a
    for ln in ((4, 7) if odd_and_even_cycles else ()):
        cyc = perm[pos:pos + ln]
        pos += ln
        exists[cyc] = True
        for a, b in zip(cyc, np.roll(cyc, -1)):
            prev[b] = a
    return prev, exists


def test_sharded_list_rank_matches_jax(jmesh):
    rng = np.random.default_rng(105)
    cap = 64
    prev, exists = _chains(rng, D * cap)
    want = jsg.sharded_list_rank(
        jsg.Router(jmesh, cap), jnp.asarray(prev.reshape(D, cap)),
        jnp.asarray(exists.reshape(D, cap)))
    got = tsg.sharded_list_rank(
        tsg.Router(cpu_mesh(), cap), shards(prev.reshape(D, cap)),
        shards(exists.reshape(D, cap), torch.bool))
    live = exists.reshape(D, cap)
    for name, g, w in zip(("head", "rank", "is_head"), got, want):
        g, w = stacked(g), np.asarray(w)
        if name != "is_head":
            g, w = g[live], w[live]
        np.testing.assert_array_equal(g, w, err_msg=name)
    # and the JAX package's dense ranking says the same
    head_d, rank_d, _ = jranking.list_rank(jnp.asarray(prev),
                                           jnp.asarray(exists))
    np.testing.assert_array_equal(stacked(got[0]).reshape(-1)[exists],
                                  np.asarray(head_d)[exists])
    np.testing.assert_array_equal(stacked(got[1]).reshape(-1)[exists],
                                  np.asarray(rank_d)[exists])


# ---- port only: every mesh size gives the dense answer ----------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_port_primitives_equal_dense_at_every_mesh_size(d):
    rng = np.random.default_rng(200 + d)
    cap = 512 // d
    mesh = cpu_mesh(d)
    router = tsg.Router(mesh, cap)
    x = rng.integers(0, 1000, size=(d * cap, 3))
    # ragged: every shard asks a different number of queries
    idx = [rng.integers(-2, d * cap, size=10 + 7 * s) for s in range(d)]
    got = router.gather(shards(x.reshape(d, cap, 3)),
                        [torch.from_numpy(i) for i in idx])
    for g, i in zip(got, idx):
        want = np.where(i[:, None] >= 0, x[np.clip(i, 0, None)], -1)
        np.testing.assert_array_equal(g.numpy(), want)

    vals = [rng.integers(0, 50, size=i.shape[0]) for i in idx]
    for op, init, fold in (("add", 0, np.add), ("max", tsg._NEG, np.maximum),
                           ("or", 0, np.maximum)):
        acc = router.scatter1([torch.from_numpy(i) for i in idx],
                              [torch.from_numpy(v) for v in vals], op=op)
        want = np.full(d * cap, init, np.int64)
        for i, v in zip(idx, vals):
            fold.at(want, i[i >= 0], v[i >= 0])
        np.testing.assert_array_equal(
            torch.cat(acc).numpy(), want, err_msg=op)

    prev, exists = _chains(rng, d * cap)
    head, rank, is_head = tsg.sharded_list_rank(
        router, shards(prev.reshape(d, cap)),
        shards(exists.reshape(d, cap), torch.bool))
    want = tranking.list_rank(torch.from_numpy(prev).to(torch.int64),
                              torch.from_numpy(exists))
    for g, w in zip((head, rank, is_head), want):
        np.testing.assert_array_equal(torch.cat(g).numpy()[exists],
                                      w.numpy()[exists])


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_port_lookup_equals_dense_at_every_mesh_size(d):
    rng = np.random.default_rng(300 + d)
    can, keys, n, gid, cap = _random_sharded_table(rng, 300, d)
    pick = rng.integers(0, can.shape[0], size=d * 40)
    deleted = np.zeros((d, cap), bool)
    deleted.reshape(-1)[gid[::5]] = True
    got = tsg.Router(cpu_mesh(d), cap).lookup(
        shards(keys), n.tolist(), shards(deleted, torch.bool),
        shards(can[pick].reshape(d, 40, -1)), k=K)
    want = np.where(np.isin(pick, np.arange(0, can.shape[0], 5)), -1,
                    gid[pick])
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("k", [13, 23, 31, 63, 127])
def test_owner_boundaries_equal_jax(k):
    for d in (2, 4, 8):
        want = jsc._owner_boundaries(k, d)
        got = tsc._owner_boundaries(k, d)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert (np.diff(got.astype(np.int64)) > 0).all()


def _long_chains(rng, n, lengths, cycles, descending=False):
    """Chains and cycles of the given lengths over a random permutation
    of n ids; the rest do not exist.  ``descending``: every chain's ids
    fall from its head to its tail, so each id is the least of those
    from it to the head from the start."""
    prev = np.full(n, -1, np.int64)
    exists = np.zeros(n, bool)
    perm = rng.permutation(n)
    pos = 0
    for ln, closed in [(x, False) for x in lengths] + \
            [(x, True) for x in cycles]:
        chain = perm[pos:pos + ln]
        if descending:
            chain = np.sort(chain)[::-1]
        pos += ln
        exists[chain] = True
        for a, b in zip(chain[:-1], chain[1:]):
            prev[b] = a
        if closed:
            prev[chain[0]] = chain[-1]
    return prev, exists


@pytest.mark.parametrize("lengths,cycles,descending", [
    ((300, 17, 1, 2), (), False),
    ((300, 17, 1, 2), (), True),
    ((5, 64, 65), (1, 2, 64), False),
    ((), (3, 100), False),
    ((), (), False),
], ids=["chains", "descending_chains", "chains_and_cycles", "cycles",
        "nothing"])
def test_port_list_rank_stops_when_a_round_changes_nothing(
        monkeypatch, lengths, cycles, descending):
    """A lane leaves the doubling once its pointer rests, and the
    doubling ends when no lane moves: it answers as the dense ranking
    does, in a few rounds more than log2 of the longest chain rather
    than log2 of the id space, each round asking for the lanes that
    have a predecessor at most.  On a cycle whose length is no power of
    two the pointers of the first pass never come to rest, so that pass
    runs every round; the second pass, on the cycles broken into
    chains, stops early all the same."""
    d, cap = 4, 1024
    rng = np.random.default_rng(400 + len(lengths) + 3 * len(cycles))
    prev, exists = _long_chains(rng, d * cap, lengths, cycles, descending)
    router = tsg.Router(cpu_mesh(d), cap)
    gathers = []
    gather = router.gather
    monkeypatch.setattr(router, "gather", lambda x, idx: (
        gathers.append(sum(i.numel() for i in idx)), gather(x, idx))[1])
    got = tsg.sharded_list_rank(router, shards(prev.reshape(d, cap)),
                                shards(exists.reshape(d, cap), torch.bool))
    want = tranking.list_rank(torch.from_numpy(prev),
                              torch.from_numpy(exists))
    for name, g, w in zip(("head", "rank", "is_head"), got, want):
        np.testing.assert_array_equal(torch.cat(g).numpy()[exists],
                                      w.numpy()[exists], err_msg=name)
    np.testing.assert_array_equal(torch.cat(got[2]).numpy(),
                                  want[2].numpy())
    longest = max((*lengths, *cycles, 1))
    steps = (d * cap).bit_length()
    # a pass that stops early: the rounds that move something, and one
    # that does not
    short = longest.bit_length() + 1
    restless = any(c & (c - 1) for c in cycles)
    rounds = len(gathers) - 1  # the gather between the passes
    assert rounds <= (steps if restless else short) + short < 2 * steps
    # every lane, once, between the passes; in the rounds only lanes
    # with a predecessor, fewer as their pointers come to rest
    assert d * cap in gathers
    linked = int((prev >= 0).sum())
    asked = sum(gathers) - d * cap
    assert asked <= rounds * linked
    if linked and not restless:
        assert asked < rounds * linked
