"""Port parity: the host readers the port carries as its own copies
(``io/libconfig``, ``io/bam``, ``io/native``, ``io/fastx``) give the
same config and the same read batches as the JAX package's, and the
port's pregraph-file loader gives the JAX loader's state; the native
decoder's first build is safe to race."""

import dataclasses
import gzip
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu.io import fastx as jfastx
from soapdenovo_trans_tpu.io import graph_files as jgraph_files
from soapdenovo_trans_tpu.io import libconfig as jlibconfig
from soapdenovo_trans_tpu.io import native as jnative
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.io import fastx as tfastx
from soapdenovo_trans_tpu_torch.io import graph_files as tgraph_files
from soapdenovo_trans_tpu_torch.io import libconfig as tlibconfig
from soapdenovo_trans_tpu_torch.io import native as tnative
from tests.test_io import _write_fake_bam


def _reads(rng, n):
    return ["".join(rng.choice(list("ACGTN"), size=int(rng.integers(5, 40))))
            for _ in range(n)]


@pytest.fixture
def libs(tmp_path):
    """One config with every source kind: f1/f2 pairs (reverse_seq=1),
    gzipped FASTQ pairs, an interleaved `p` file, single FASTA/FASTQ
    files and a BAM."""
    rng = np.random.default_rng(5)
    fa = {}
    for name in ("a_1.fa", "a_2.fa", "p.fa", "s.fa"):
        fa[name] = str(tmp_path / name)
        jfastx.write_fasta(fa[name], [(f"r{i}", s) for i, s in
                                      enumerate(_reads(rng, 21))])
    fq = {}
    for name in ("b_1.fq.gz", "b_2.fq.gz", "s.fq"):
        fq[name] = str(tmp_path / name)
        opener = gzip.open if name.endswith(".gz") else open
        with opener(fq[name], "wt") as fh:
            for i, s in enumerate(_reads(rng, 13)):
                fh.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")
    bam = str(tmp_path / "t.bam")
    _write_fake_bam(bam, [(s, [0, 0x10, 0x200][i % 3])
                          for i, s in enumerate(_reads(rng, 17))])
    cfg = tmp_path / "t.config"
    cfg.write_text(
        "# every source kind\nmax_rd_len=30\n"
        f"[LIB]\navg_ins=300\nreverse_seq=1\nrd_len_cutof=25\n"
        f"f1={fa['a_1.fa']}\nf2={fa['a_2.fa']}\n"
        f"[LIB]\navg_ins=200\nasm_flags=1\npair_num_cutoff=4\n"
        f"q1={fq['b_1.fq.gz']}\nq2={fq['b_2.fq.gz']}\n"
        f"[LIB]\navg_ins=150\np={fa['p.fa']}\n"
        f"[LIB]\nasm_flags=2\nf={fa['s.fa']}\nq={fq['s.fq']}\n"
        f"[LIB]\navg_ins=100\nmap_len=32\nb={bam}\n")
    return str(cfg)


def test_config_matches_jax(libs):
    want = jlibconfig.parse_config(libs)
    got = tlibconfig.parse_config(libs)
    assert got.max_rd_len == want.max_rd_len
    assert [dataclasses.asdict(x) for x in got.libs] == \
        [dataclasses.asdict(x) for x in want.libs]
    assert [x.has_pairs for x in got.libs] == [x.has_pairs for x in want.libs]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("purpose", [1, 2])
def test_read_batches_match_jax(libs, native, purpose, monkeypatch):
    if native and not tnative.available():
        pytest.skip("no g++/zlib toolchain")
    if not native:  # both packages read every library in Python
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    want = list(jfastx.config_read_batches(
        jlibconfig.parse_config(libs), 8, purpose=purpose))
    got = list(tfastx.config_read_batches(
        tlibconfig.parse_config(libs), 8, purpose=purpose))
    assert len(got) == len(want) > 2
    for (wc, wl, wi), (gc, gl, gi) in zip(want, got):
        assert gi == wi
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("k", [23, 31])
def test_load_pregraph_files_matches_jax(k, tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=400, seed=6)
    out = str(tmp_path / "pre")
    tcli.main(["pregraph", "-s", cfg, "-K", str(k), "-o", out])
    jt, je, ja, jk = jgraph_files.load_pregraph_files(out)
    tt, te, ta, tk = tgraph_files.load_pregraph_files(out, "cpu")
    assert tk == jk == k

    def eq(want, got, n, msg):
        np.testing.assert_array_equal(
            np.asarray(want)[:n].astype(np.int64), got[:n].numpy(),
            err_msg=msg)

    assert tt.n == int(jt.n) > 0
    eq(jt.keys, tt.keys, tt.n, "vertex keys")
    n_e = te.n_edges
    assert n_e == int(je.n_edges) > 0
    for field in ("from_node", "to_node", "length", "cvg", "twin",
                  "seq_off"):
        eq(getattr(je, field), getattr(te, field), n_e, field)
    eq(je.seq_pool, te.seq_pool, int(te.length.sum()), "seq_pool")
    assert not te.deleted.any()
    assert ta.n == int(ja.n) > 0
    for field in ("from_ed", "to_ed", "mult"):
        eq(getattr(ja, field), getattr(ta, field), ta.n, field)


def test_native_load_is_thread_safe(tmp_path, monkeypatch):
    """Threads that call ``_load`` while the first one builds the library
    wait for it: all get the same library, none gets None."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_checked", False)
    n = 12
    start = threading.Barrier(n)
    got = [None] * n

    def call(i):
        start.wait(timeout=60)
        got[i] = tnative._load()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got[0] is not None
    assert all(lib is got[0] for lib in got)
    assert len(list((tmp_path / "build").glob("libfastx_*.so"))) == 1
