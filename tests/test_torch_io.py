"""Port parity: the host readers the port carries as its own copies
(``io/libconfig``, ``io/bam``, ``io/native``, ``io/fastx``) give the
same config and the same read batches as the JAX package's, and the
port's pregraph-file loader gives the JAX loader's state; the native
decoder's first build is safe to race.  Paired libraries through the
native decoder give the Python decoder's batches, and what the two
decoders would read differently stays on the Python one."""

import dataclasses
import gzip
import shutil
import sys
import threading

import numpy as np
import pytest
import torch

import perf_e2e
from port_bench import synth
from soapdenovo_trans_tpu.io import fastx as jfastx
from soapdenovo_trans_tpu.io import graph_files as jgraph_files
from soapdenovo_trans_tpu.io import libconfig as jlibconfig
from soapdenovo_trans_tpu.io import native as jnative
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.io import fastx as tfastx
from soapdenovo_trans_tpu_torch.io import graph_files as tgraph_files
from soapdenovo_trans_tpu_torch.io import libconfig as tlibconfig
from soapdenovo_trans_tpu_torch.io import native as tnative
from soapdenovo_trans_tpu_torch.utils import profiling
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


def _batches(cfg_path, batch_size, purpose=1, python=False, mp=None):
    """Every batch of ``config_read_batches`` (copied), the message of
    the ValueError that ended the stream (or None) and the counters;
    ``python`` reads with the native decoder reported missing."""
    if python:
        mp.setattr(tnative, "available", lambda: False)
    rec = profiling.StageTimings()
    got, err = [], None
    try:
        with profiling.active(rec):
            for codes, lens, li in tfastx.config_read_batches(
                    tlibconfig.parse_config(cfg_path), batch_size,
                    purpose=purpose):
                got.append((codes.copy(), lens.copy(), li))
    except ValueError as e:
        err = str(e)
    finally:
        if python:
            mp.undo()
    return got, err, rec.counters


def _assert_same(want, got):
    assert len(got) == len(want)
    for (wc, wl, wi), (gc, gl, gi) in zip(want, got):
        assert gi == wi
        assert gc.dtype == wc.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gc, wc)


def _write_reads(path, reads, width=100, blank=False):
    """FASTA or FASTQ (by the name), gzipped for a ``.gz`` name; FASTA
    records wrapped at ``width``, with a blank line after each where
    ``blank``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for i, s in enumerate(reads):
            if ".fq" in path:
                fh.write(f"@r{i}/1\n{s}\n+\n{'I' * len(s)}\n")
                continue
            fh.write(f">r{i} some description\n")
            for j in range(0, len(s), width):
                fh.write(s[j: j + width] + "\n")
            if blank:
                fh.write("\n")


_PAIRED_CASES = {
    # case: (mate file suffix, pairs in mate 1 / mate 2, batch size,
    #        read lengths, alphabet, wrap width, blank lines, extras)
    "fasta": (".fa", 37, 37, 8, (5, 40), "ACGTN", 100, False, ()),
    "fasta_gz": (".fa.gz", 37, 37, 8, (5, 40), "ACGTN", 100, False, ()),
    "fastq": (".fq", 29, 29, 8, (5, 40), "ACGTN", 100, False, ()),
    "fastq_gz": (".fq.gz", 29, 29, 6, (0, 40), "ACGTN", 100, False, ()),
    "odd_batch": (".fa", 37, 37, 7, (5, 40), "ACGTN", 100, False, ()),
    "batch_1": (".fa", 9, 9, 1, (5, 40), "ACGTN", 100, False, ()),
    "multiline": (".fa", 23, 23, 8, (5, 40), "ACGTN", 7, True, ()),
    "iupac_lower": (".fa", 23, 23, 8, (5, 40),
                    "ACGTNacgtnRYKMSWBDHVUryk-.*", 100, False, ()),
    "long": (".fa", 23, 23, 8, (20, 70), "ACGT", 100, False, ()),
    "with_singles": (".fa", 19, 19, 8, (5, 40), "ACGTN", 100, False,
                     ("b", "p", "f", "q")),
    "mate2_short": (".fa", 21, 17, 8, (5, 40), "ACGTN", 100, False, ()),
    "mate1_short": (".fa", 17, 21, 8, (5, 40), "ACGTN", 100, False, ()),
}


@pytest.mark.parametrize("purpose", [1, 2])
@pytest.mark.parametrize("case", sorted(_PAIRED_CASES))
def test_paired_native_matches_python(case, purpose, tmp_path, monkeypatch):
    """A paired library read by the native decoder, each mate's file in
    its own stream interleaved by rows, gives the Python decoder's
    batches byte for byte, the library's other sources filled in across
    batches in lib_reads's order; unequal mate counts end as the Python
    path ends them.  Every batch is the native decoder's."""
    if not tnative.available():
        pytest.skip("no g++/zlib toolchain")
    (suffix, n1, n2, batch, (lo, hi), alphabet, width, blank,
     extras) = _PAIRED_CASES[case]
    rng = np.random.default_rng(sorted(_PAIRED_CASES).index(case))

    def reads(n, lo=lo):
        return ["".join(rng.choice(list(alphabet),
                                   size=int(rng.integers(lo, hi))))
                for _ in range(n)]

    m1, m2 = (str(tmp_path / f"m_{i}{suffix}") for i in (1, 2))
    _write_reads(m1, reads(n1), width, blank)
    _write_reads(m2, reads(n2), width, blank)
    key = "q" if ".fq" in suffix else "f"
    lines = [f"max_rd_len=60\n[LIB]\navg_ins=300\nasm_flags=3\n"
             f"rd_len_cutof=50\n{key}1={m1}\n{key}2={m2}\n"]
    if "b" in extras:
        bam = str(tmp_path / "t.bam")
        _write_fake_bam(bam, [(s, [0, 0x10, 0x200][i % 3])
                              for i, s in enumerate(reads(11))])
        lines.append(f"b={bam}\n")
    for kind in extras[1:]:
        path = str(tmp_path / (f"{kind}.fq" if kind == "q" else
                               f"{kind}.fa"))
        _write_reads(path, reads(13))
        lines.append(f"{kind}={path}\n")
    # a second paired library, read for contigs only
    o1, o2 = (str(tmp_path / f"o_{i}.fa") for i in (1, 2))
    _write_reads(o1, reads(5, 5))
    _write_reads(o2, reads(5, 5))
    lines.append(f"[LIB]\navg_ins=200\nasm_flags=1\nf1={o1}\nf2={o2}\n")
    cfg = tmp_path / "t.config"
    cfg.write_text("".join(lines))

    want, want_err, _ = _batches(str(cfg), batch, purpose, python=True,
                                 mp=monkeypatch)
    got, got_err, counters = _batches(str(cfg), batch, purpose)
    assert got_err == want_err
    assert (want_err is not None) == (case == "mate2_short")
    _assert_same(want, got)
    assert counters["reads.batches_native"] == counters["reads.batches"] \
        == len(got)


def test_read_counters_native_on_bench_dataset(tmp_path, monkeypatch):
    """The benchmark's dataset (``port_bench/synth.write_dataset``, a
    paired FASTA larger than the sniff's 64 KiB) is read by the native
    decoder alone, and its batches are the Python decoder's."""
    if not tnative.available():
        pytest.skip("no g++/zlib toolchain")
    reads = synth.make_reads(11, 20, 3000, 100, 300)
    cfg = synth.write_dataset(str(tmp_path), reads, 100, 300)
    assert (tmp_path / "reads_1.fa").stat().st_size > (1 << 16)
    want, _, _ = _batches(cfg, 1024, python=True, mp=monkeypatch)
    got, err, counters = _batches(cfg, 1024)
    assert err is None
    _assert_same(want, got)
    assert counters["reads.batches_native"] == counters["reads.batches"] \
        == len(got) == 6


def _mates(tmp_path, text1, text2, suffix=".fa", extra=""):
    m1, m2 = (str(tmp_path / f"m_{i}{suffix}") for i in (1, 2))
    with open(m1, "w", newline="") as fh:
        fh.write(text1)
    with open(m2, "w", newline="") as fh:
        fh.write(text2)
    key = "q" if suffix == ".fq" else "f"
    cfg = tmp_path / "t.config"
    cfg.write_text(f"max_rd_len=60\n[LIB]\navg_ins=300\n{extra}"
                   f"{key}1={m1}\n{key}2={m2}\n")
    return str(cfg)


def _fa(n, seed, eol="\n"):
    rng = np.random.default_rng(seed)
    return "".join(f">r{i}{eol}" + "".join(rng.choice(list("ACGT"), 30)) +
                   eol for i in range(n))


_PYTHON_CASES = {
    # case: (mate 1, mate 2, file suffix, library keys)
    "reverse_seq": (_fa(9, 1), _fa(9, 2), ".fa", "reverse_seq=1\n"),
    "crlf": (_fa(9, 1, "\r\n"), _fa(9, 2, "\r\n"), ".fa", ""),
    "trailing_space": (_fa(9, 1).replace("\n>", " \n>"), _fa(9, 2), ".fa",
                       ""),
    "empty_record": (">e\n" + _fa(9, 1), ">e\n" + _fa(9, 2), ".fa", ""),
    "bases_before_header": ("ACGT\n" + _fa(8, 1), "ACGT\n" + _fa(8, 2),
                            ".fa", ""),
    "gt_inside_bases": (_fa(9, 1).replace("\nA", "\nA>", 1), _fa(9, 2),
                        ".fa", ""),
    "fastq_blank_line": ("@a\nACGT\n+\nIIII\n\n@b\nGG\n+\nII\n",
                         "@a\nTT\n+\nII\n@b\nCC\n+\nII\n", ".fq", ""),
    "fastq_short_qual": ("@a\nACGT\n+\nII\nIIII\n@b\nGG\n+\nII\n",
                         "@a\nTT\n+\nII\n@b\nCC\n+\nII\n", ".fq", ""),
    "fastq_named_fasta": ("@a\nACGT\n+\nIIII\n", "@a\nTT\n+\nII\n", ".fa",
                          ""),
}


@pytest.mark.parametrize("case", sorted(_PYTHON_CASES))
def test_read_counters_python_decoder(case, tmp_path, monkeypatch):
    """Libraries that the two decoders would read differently (and
    ``reverse_seq=1``, which the native decoder cannot complement
    before it truncates) take the Python decoder: no batch is the
    native decoder's, and the batches are the Python path's."""
    if not tnative.available():
        pytest.skip("no g++/zlib toolchain")
    text1, text2, suffix, extra = _PYTHON_CASES[case]
    cfg = _mates(tmp_path, text1, text2, suffix, extra)
    want, want_err, _ = _batches(cfg, 4, python=True, mp=monkeypatch)
    got, got_err, counters = _batches(cfg, 4)
    assert got_err == want_err
    _assert_same(want, got)
    assert counters["reads.batches"] == len(got) > 0
    assert counters["reads.batches_native"] == 0


@pytest.mark.parametrize("head, whole, fastq, alike", [
    (b"", True, False, True),
    (b"\n\n>a\nACGT\nac\n\n>b\nNNRY\n", True, False, True),
    (b">a\nACGT\n>b\n", True, False, False),        # empty last record
    (b">a\nACGT\n>b\n", False, False, True),        # ... or cut by the sniff
    (b">a\nAC GT\n", True, False, False),
    (b">a\nACGT\t\n", True, False, False),
    (b">a\nAC\xc3\x9fGT\n", True, False, False),
    (b"@a\nACGT\n+\nIIII\n@b\n\n+\n\n", True, True, True),
    (b"@a\nACGT\n+\nIIII\n@b\nAC", False, True, True),
    (b"@a\nACGT\n+\nIIII\n@b\nAC\n", True, True, False),  # cut record
    (b"@a\nACGT\n+\nIIII\n\n", True, True, False),  # blank tail line
    (b"@a\nACGT\nIIII\n+\n", True, True, False),
])
def test_text_alike(head, whole, fastq, alike):
    assert tfastx._text_alike(head, whole, fastq) is alike
