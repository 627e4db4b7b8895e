"""The mesh-resident pregraph passes of the port
(parallel/sharded_pregraph.py) against the JAX package's on its 8-device
CPU mesh: the same sharded table, made from a numpy seed, goes through
both; tolerance 0 (integers; live prefixes of the edge arrays).  Then,
port only: every mesh size gives the dense result, two shard capacities
give the same edges, and the CLI takes the mesh path from
SOAPDENOVO_TORCH_DEVICE."""

import gzip
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import perf_e2e
from soapdenovo_trans_tpu.graph import arcs as jarcs
from soapdenovo_trans_tpu.graph import unitigs as junitigs
from soapdenovo_trans_tpu.ops import bits as jbits
from soapdenovo_trans_tpu.ops import dictionary as jdict
from soapdenovo_trans_tpu.ops import kmer as jkmer
from soapdenovo_trans_tpu.parallel import sharded_count as jsc
from soapdenovo_trans_tpu.parallel import sharded_graph as jsg
from soapdenovo_trans_tpu.parallel import sharded_pregraph as jsp
from soapdenovo_trans_tpu.stages import pregraph as jpg
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch import convert
from soapdenovo_trans_tpu_torch.graph import arcs as tarcs
from soapdenovo_trans_tpu_torch.graph import unitigs as tunitigs
from soapdenovo_trans_tpu_torch.io import fastx
from soapdenovo_trans_tpu_torch.parallel import sharded_count as tsc
from soapdenovo_trans_tpu_torch.parallel import sharded_pregraph as tsp
from soapdenovo_trans_tpu_torch.parallel.mesh import Mesh
from soapdenovo_trans_tpu_torch.stages import pregraph as tpg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
K = 13
ALPH = "ACGT"
READ_LEN = 36


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:D]), (jsg.AXIS,))


def random_reads(seed, n_transcripts=3, t_len=150, step=2, with_tips=True,
                 isoforms=False):
    """Reads tiling random transcripts (with ``isoforms``, the last one
    is the first with its middle replaced: branch vertices, and reads
    that cross edges), plus a few 1x tip reads."""
    rng = np.random.default_rng(seed)
    reads = []
    first = None
    for n in range(n_transcripts):
        t = "".join(ALPH[i] for i in rng.integers(0, 4, t_len))
        if isoforms and n == n_transcripts - 1:
            t = first[:55] + t[55:95] + first[95:]
        first = first or t
        for i in range(0, t_len - READ_LEN + 1, step):
            r = t[i:i + READ_LEN]
            reads.append(jbits.revcomp_str(r) if rng.random() < 0.5 else r)
        if with_tips:  # a single-copy erroneous read off the transcript
            pos = int(rng.integers(0, t_len - READ_LEN))
            err = list(t[pos:pos + READ_LEN])
            err[-3] = ALPH[(ALPH.index(err[-3]) + 1) % 4]
            reads.append("".join(err))
    rng.shuffle(reads)
    return reads


def encode_batch(reads, read_len=READ_LEN, rows=None):
    codes = np.full((rows or len(reads), read_len), 4, np.uint8)
    lens = np.zeros(codes.shape[0], np.int32)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = jbits.encode_seq(r)
        lens[i] = len(r)
    return codes, lens


def split_table(table, k=K, d=D):
    """The JAX package's dense KmerTable -> its ShardedTable (numpy
    fields) with the capacity its tests use."""
    n = int(table.n)
    keys = np.asarray(table.keys)[:n]
    fields = [np.asarray(x)[:n] for x in (table.count, table.l_cov,
                                          table.r_cov)]
    splits = np.searchsorted(keys[:, 0], jsc._owner_boundaries(k, d))
    starts = np.concatenate([[0], splits, [n]])
    per = np.diff(starts)
    cap = jdict.round_up(max(int(per.max()), 1))
    sk = np.full((d, cap, keys.shape[1]), 0xFFFFFFFF, np.uint32)
    out = [np.zeros((d, cap) + f.shape[1:], np.int32) for f in fields]
    for s in range(d):
        a, b = starts[s], starts[s + 1]
        sk[s, :b - a] = keys[a:b]
        for o, f in zip(out, fields):
            o[s, :b - a] = f[a:b]
    return jsc.ShardedTable(sk, *out, per.astype(np.int32)), cap


class Fixture:
    """One read set as the JAX package's sharded table and the port's,
    with the SAME capacity, so global ids are comparable one to one."""

    def __init__(self, jmesh, seed, with_tips, isoforms=False):
        self.codes, self.lens = encode_batch(random_reads(
            seed, with_tips=with_tips, isoforms=isoforms))
        stream = jkmer.chop_reads(jnp.asarray(self.codes),
                                  jnp.asarray(self.lens), K)
        jst, self.cap = split_table(jdict.build(stream, K))
        self.jmesh = jmesh
        self.jst = jsc.ShardedTable(*(jnp.asarray(x) for x in jst))
        self.jrouters = jsp.Routers.build(jmesh, self.cap)
        self.jdeleted = jnp.zeros((D, self.cap), jnp.int32)
        self.mesh = Mesh(["cpu"] * D)
        self.st = convert.sharded_to_torch(jst, self.mesh)
        self.routers = tsp.Routers.build(self.mesh, self.cap)
        self.deleted = [torch.zeros(self.cap, dtype=torch.bool)
                        for _ in range(D)]


def stacked(xs):
    return np.stack([x.numpy() for x in xs])


def test_dbg_matches_jax(jmesh):
    fx = Fixture(jmesh, 3, True)
    want = jsp.build_dbg_sharded(jmesh, fx.jrouters, fx.jst, fx.jdeleted, K)
    got = tsp.build_dbg_sharded(fx.mesh, fx.routers, fx.st, fx.deleted, K)
    assert got._fields == want._fields
    for f in got._fields:
        np.testing.assert_array_equal(
            stacked(getattr(got, f)), np.asarray(getattr(want, f)), f)
    assert stacked(got.exists).sum() > 100


@pytest.mark.parametrize("deleted_every", [0, 7], ids=["none", "some"])
def test_dbg_looks_up_only_covered_live_slots(jmesh, monkeypatch,
                                              deleted_every):
    """An arc slot without coverage can hold no arc, so its successor is
    not looked up: the routed lookups carry one query a covered slot of
    a live row, and the graph is the JAX package's all the same."""
    fx = Fixture(jmesh, 3, True)
    deleted = np.zeros((D, fx.cap), bool)
    if deleted_every:
        deleted.reshape(-1)[::deleted_every] = True
    jdel = jnp.asarray(deleted.astype(np.int32))
    tdel = [torch.from_numpy(x) for x in deleted]
    asked = []
    lookup = fx.routers.row.lookup

    def counted(keys, n, dead, queries, k):
        asked.append(sum(int((q != 0xFFFFFFFF).any(-1).sum())
                         for q in queries))
        return lookup(keys, n, dead, queries, k=k)

    monkeypatch.setattr(fx.routers.row, "lookup", counted)
    got = tsp.build_dbg_sharded(fx.mesh, fx.routers, fx.st, tdel, K)
    want = jsp.build_dbg_sharded(jmesh, fx.jrouters, fx.jst, jdel, K)
    for f in got._fields:
        np.testing.assert_array_equal(
            stacked(getattr(got, f)), np.asarray(getattr(want, f)), f)
    covered = (stacked(got.out_cov) > 0) & stacked(got.live)[..., None]
    assert sum(asked) == covered.sum() < 8 * stacked(got.live).sum() / 2


def test_tip_clip_matches_jax(jmesh):
    fx = Fixture(jmesh, 5, True)
    want = jsp.clip_tip_kmers_sharded(jmesh, fx.jrouters, fx.jst,
                                      fx.jdeleted, K)
    got = tsp.clip_tip_kmers_sharded(fx.mesh, fx.routers, fx.st,
                                     fx.deleted, K)
    np.testing.assert_array_equal(stacked(got), np.asarray(want) > 0)
    assert stacked(got).sum() > 0


@pytest.fixture(scope="module")
def condensed(jmesh):
    """Both packages' condense_sharded on one fixture."""
    fx = Fixture(jmesh, 11, False, isoforms=True)
    fx.jout = jsp.condense_sharded(jmesh, fx.jrouters, fx.jst, fx.jdeleted,
                                   K)
    fx.out = tsp.condense_sharded(fx.mesh, fx.routers, fx.st, fx.deleted, K)
    return fx


def test_condense_matches_jax(condensed):
    jeg, jtab, jnode_edge, jnode_pos = condensed.jout
    eg, tab, node_edge, node_pos = condensed.out
    n = int(jeg.n_edges)
    assert eg.n_edges == n > 0
    got = convert.to_numpy(eg)
    for f in ("from_node", "to_node", "length", "cvg", "twin", "seq_off",
              "deleted"):
        np.testing.assert_array_equal(
            getattr(got, f)[:n], np.asarray(getattr(jeg, f))[:n], f)
    total = int(np.asarray(jeg.length)[:n].sum())
    np.testing.assert_array_equal(got.seq_pool[:total],
                                  np.asarray(jeg.seq_pool)[:total])
    m = int(jtab.n)
    assert tab.n == m
    np.testing.assert_array_equal(convert.to_numpy(tab).keys[:m],
                                  np.asarray(jtab.keys)[:m])
    np.testing.assert_array_equal(stacked(node_edge), np.asarray(jnode_edge))
    np.testing.assert_array_equal(stacked(node_pos), np.asarray(jnode_pos))
    # exact sizes on the port's side
    assert got.length.shape[0] == n and got.seq_pool.shape[0] == total


def test_thread_reads_matches_jax(condensed):
    fx = condensed
    jeg, jtab, jnode_edge, jnode_pos = fx.jout
    eg, tab, node_edge, _node_pos = fx.out
    pad = -fx.codes.shape[0] % D
    codes = np.concatenate([fx.codes, np.full((pad, READ_LEN), 4, np.uint8)])
    lens = np.concatenate([fx.lens, np.zeros(pad, np.int32)])
    jf, jt, jv = jsp.thread_reads_sharded(
        fx.jmesh, fx.jrouters, fx.jst, fx.jdeleted, jnode_edge, jnode_pos,
        jeg, jarcs.build_patch(jeg, jtab, K), codes, lens, K)
    patch = tarcs.build_patch(eg, tab, K)
    # the unpadded rows: the port pads the last shards itself
    f, t, v = tsp.thread_reads_sharded(
        fx.mesh, fx.routers, fx.st, fx.deleted, node_edge, eg, patch,
        fx.codes, fx.lens, K)
    assert f.shape == jf.shape
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_array_equal(f.numpy()[jv], jf[jv])
    assert jv.sum() > 0
    want = jarcs.count_arcs(jnp.asarray(jf), jnp.asarray(jt),
                            jnp.asarray(jv), jeg.twin)
    got = convert.to_numpy(tarcs.count_arcs(f, t, v, eg.twin))
    a = int(want.n)
    assert got.from_ed.shape[0] == a
    for name in ("from_ed", "to_ed", "mult"):
        np.testing.assert_array_equal(
            getattr(got, name), np.asarray(getattr(want, name))[:a], name)


def test_kmer_freq_matches_jax(jmesh):
    fx = Fixture(jmesh, 5, True)
    jdel = np.zeros((D, fx.cap), np.int32)
    jdel[:, ::4] = 1
    want = jsp.kmer_freq_sharded(jmesh, fx.jst, jnp.asarray(jdel))
    got = tsp.kmer_freq_sharded(fx.mesh, fx.st, [
        torch.from_numpy(x > 0) for x in jdel])
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0 and got.shape == (256,)


# ---- port only --------------------------------------------------------


def branch_reads():
    """The 128-read fixture of the JAX package's sharded end-to-end
    test: two isoforms sharing flanks, so branch vertices and
    edge-crossing reads make the preArcs meaningful."""
    rng = np.random.default_rng(21)
    a, b = ("".join(rng.choice(list(ALPH), size=120)) for _ in range(2))
    c1, c2 = ("".join(rng.choice(list(ALPH), size=40)) for _ in range(2))
    reads = []
    for t in (a + c1 + b, a + c2 + b):
        for i in range(0, len(t) - 50 + 1, 4):
            reads.append(t[i:i + 50])
    return reads[:128]


def edge_set(res, k):
    """Sorted edge sequences of a port PregraphResult."""
    return sorted(tunitigs.edge_sequences(res.edges, res.table, k))


def arc_rows(res):
    a = res.arcs
    return [x[:a.n].tolist() for x in (a.from_ed, a.to_ed, a.mult)]


@pytest.fixture(scope="module")
def dense_branch():
    codes, lens = encode_batch(branch_reads(), 50, rows=128)
    factory = lambda: iter([(codes[:70], lens[:70], 0),
                            (codes[70:], lens[70:], 0)])
    return factory, tpg.run_pregraph(factory, 23, torch.device("cpu"))


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_pregraph_equals_dense_at_every_mesh_size(d, dense_branch):
    factory, dense = dense_branch
    sharded = tpg.run_pregraph(factory, 23, torch.device("cpu"),
                               mesh=Mesh(["cpu"] * d))
    assert sharded.n_distinct == dense.n_distinct == dense.table.n
    assert sharded.table.n < dense.table.n  # the mini endpoint table
    np.testing.assert_array_equal(sharded.freq_hist,
                                  tpg.kmer_freq_histogram(dense.table))
    assert edge_set(sharded, 23) == edge_set(dense, 23)
    # not just the same sets: the same edge ids, so the same arcs
    for f in ("length", "cvg", "twin", "seq_off", "seq_pool"):
        assert torch.equal(getattr(sharded.edges, f),
                           getattr(dense.edges, f)), f
    assert arc_rows(sharded) == arc_rows(dense) and dense.arcs.n > 0
    assert set(sharded.phase_seconds) == {"count", "clip", "condense",
                                          "thread"}


def test_two_caps_give_the_same_edges(dense_branch):
    """Global ids depend on the shard capacity; no output does."""
    factory, _dense = dense_branch
    mesh = Mesh(["cpu"] * 4)
    st = tpg._count_reads_sharded(factory(), 23, mesh)
    outs = []
    for cap in (st.cap, st.cap + 37):
        wide = tsc.with_cap(st, cap)
        deleted = [torch.zeros(cap, dtype=torch.bool) for _ in range(4)]
        routers = tsp.Routers.build(mesh, cap)
        deleted = tsp.clip_tip_kmers_sharded(mesh, routers, wide, deleted,
                                             23)
        eg, tab, node_edge, node_pos = tsp.condense_sharded(
            mesh, routers, wide, deleted, 23)
        outs.append((eg, tab, [x[:2 * st.cap] for x in node_edge],
                     [x[:2 * st.cap] for x in node_pos]))
    (eg_a, tab_a, ne_a, np_a), (eg_b, tab_b, ne_b, np_b) = outs
    for f in eg_a._fields:
        x, y = getattr(eg_a, f), getattr(eg_b, f)
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y, f
    assert torch.equal(tab_a.keys, tab_b.keys)
    for x, y in zip(ne_a + np_a, ne_b + np_b):
        assert torch.equal(x, y)


def test_low_freq_cutoff_and_read_paths_on_the_mesh(dense_branch):
    """-d and the -R recorder hook take the mesh path too."""
    factory, _dense = dense_branch

    class Recorder:
        MIN_PATH = 2

        def __init__(self):
            self.lengths, self.edges = [], []

        def add_paths(self, lengths, edges):
            self.lengths += lengths.tolist()
            self.edges += edges.tolist()

    recs = []

    def run(mesh):
        recs.append(Recorder())
        return tpg.run_pregraph(
            factory, 23, torch.device("cpu"), low_freq_cutoff=1,
            path_recorder_factory=lambda edges: recs[-1], mesh=mesh)

    dense, sharded = run(None), run(Mesh(["cpu"] * 4))
    assert edge_set(sharded, 23) == edge_set(dense, 23)
    assert arc_rows(sharded) == arc_rows(dense)
    assert recs[0].lengths == recs[1].lengths and recs[0].lengths
    assert recs[0].edges == recs[1].edges
    assert "record" in sharded.phase_seconds


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def test_cli_mesh_from_device_list_matches_jax_mesh(tmp_path, monkeypatch):
    """``pregraph`` and ``map -g`` with SOAPDENOVO_TORCH_DEVICE=cpu,cpu
    take the mesh path: against the JAX package's run_pregraph(mesh) at
    D = 2 (edge set, preArc count, histogram), and against the port's
    own one-device files."""
    reads = branch_reads()
    fa = str(tmp_path / "reads.fa")
    fastx.write_fasta(fa, [(f"r{i}", s) for i, s in enumerate(reads)])
    cfg = str(tmp_path / "lib.config")
    with open(cfg, "w") as fh:
        fh.write(f"max_rd_len=50\n[LIB]\nasm_flags=3\nf={fa}\n")
    codes, lens = encode_batch(reads, 50, rows=128)
    jmesh2 = JMesh(np.array(jax.devices()[:2]), (jsc.AXIS,))
    want = jpg.run_pregraph(lambda: iter([(codes, lens, 0)]), 23,
                            mesh=jmesh2)

    outs = {}
    for name, spec in (("one", "cpu"), ("mesh", "cpu,cpu")):
        monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", spec)
        outs[name] = out = str(tmp_path / name)
        res = tcli.main(["pregraph", "-s", cfg, "-K", "23", "-o", out])
        tcli.main(["contig", "-g", out])
        mres = tcli.main(["map", "-s", cfg, "-g", out])
        assert mres.mapped > 0
        if name == "mesh":
            assert res.freq_hist is not None
            assert res.n_distinct == want.n_distinct
            assert edge_set(res, 23) == sorted(junitigs.edge_sequences(
                want.edges, want.table, 23))
            assert res.arcs.n == int(want.arcs.n) > 0
            np.testing.assert_array_equal(res.freq_hist, want.freq_hist)
    for ext in (".kmerFreq", ".vertex", ".preArc", ".edge.gz", ".contig",
                ".readOnContig", ".ctg2Read", ".peGrads"):
        assert _read(outs["mesh"] + ext) == _read(outs["one"] + ext), ext

    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu, cpu ,cpu")
    assert tcli.mesh_from_env().d == 3
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    assert tcli.mesh_from_env() is None
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu,cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.mesh_from_env()


def test_default_cuda_is_a_mesh_over_all_cards(monkeypatch):
    """Plain ``cuda`` with several visible cards shards over all of
    them unless SOAPDENOVO_TORCH_NO_SHARD is set; one card is no mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("SOAPDENOVO_TORCH_DEVICE", raising=False)
    monkeypatch.delenv("SOAPDENOVO_TORCH_NO_SHARD", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(x) for x in tcli.devices_from_env()] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert tcli.mesh_from_env().d == 4
    monkeypatch.setenv("SOAPDENOVO_TORCH_NO_SHARD", "1")
    assert tcli.mesh_from_env() is None
    assert str(tcli.device_from_env()) == "cuda"
    monkeypatch.delenv("SOAPDENOVO_TORCH_NO_SHARD")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli.mesh_from_env() is None
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cuda:0,cuda:0")
    assert tcli.mesh_from_env().d == 2


def test_mesh_path_runs_without_jax(tmp_path):
    """Neither jax nor any module of the JAX package can be imported:
    ``all`` on a mesh of four CPU shards still runs to the end."""
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=300, seed=2)
    out = str(tmp_path / "nojax")
    code = (
        "import sys\n"
        "for name in ('jax', 'soapdenovo_trans_tpu'):\n"
        "    sys.modules[name] = None\n"  # any import of them now fails
        "from soapdenovo_trans_tpu_torch import cli, convert\n"
        f"res = cli.main(['all', '-s', {cfg!r}, '-K', '23', '-o', {out!r}])\n"
        "assert res.pregraph.freq_hist is not None\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['soapdenovo_trans_tpu'] is None\n")
    env = dict(os.environ, SOAPDENOVO_TORCH_DEVICE="cpu,cpu,cpu,cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "sharding kmer space over Mesh" in res.stdout
    assert "sharding contig index over Mesh" in res.stdout
    assert "stage timing:" in res.stdout
    # one process drives the mesh: no process group anywhere in the port
    pkg = os.path.join(REPO, "soapdenovo_trans_tpu_torch")
    for folder, _dirs, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(folder, name)) as fh:
                    assert "torch.distributed" not in fh.read(), name
    for ext in (".kmerFreq", ".edge.gz", ".preArc", ".contig",
                ".readOnContig", ".scafSeq"):
        assert os.path.getsize(out + ext) > 0, ext
