"""The read-path options and the map stage's gap reads, the port's CLI
against the JAX CLI on the same fixture, files byte for byte (``.gz``
files after decompression):

(c) ``pregraph -R`` then ``contig -R -g`` at K = 23, and a hand-made
    graph whose repeat edge ``solve_reps`` splits, through both contig
    stages;
(d) ``map -f -r`` at three port batch sizes, against the JAX CLI's.

One JAX run per fixture, shared by module-scoped fixtures.  The helpers
come from ``tests/test_torch_flags.py``."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu.io import fastx as jfastx
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.ops import bits as tbits

from .test_torch_flags import (CONTIG_FILES, GAP_READ_FILES, MAP_FILES,
                               PREGRAPH_FILES, _assert_same, _copy_prefix,
                               _jax_main, _port_main, _read)

PATH_FILES = (".path", ".markOnEdge")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=40,
                          n_pairs=2000, seed=1)


# --- (c) read paths and repeat splitting ----------------------------------

@pytest.fixture(scope="module")
def paths(reads_cfg, tmp_path_factory):
    """(JAX prefix, port prefix) after ``pregraph -R`` at K = 23."""
    folder = tmp_path_factory.mktemp("paths")
    jax_out, out = str(folder / "jax"), str(folder / "port")
    argv = ["pregraph", "-s", reads_cfg, "-K", "23", "-R"]
    _jax_main(argv + ["-o", jax_out])
    res = _port_main(argv + ["-o", out])
    return jax_out, out, res


def test_pregraph_paths_match_jax_cli(paths):
    jax_out, out, res = paths
    _assert_same(jax_out, out, PREGRAPH_FILES + PATH_FILES)
    assert res.path_reads > 0 and "record" in res.phase_seconds
    from soapdenovo_trans_tpu_torch.io import stagefiles
    recs = stagefiles.read_path_bin(out + ".path")
    assert len(recs) == res.path_reads and min(map(len, recs)) >= 3
    with open(out + ".markOnEdge") as fh:
        marks = [int(x) for x in fh]
    assert sum(marks) == sum(map(len, recs))  # none saturates here
    assert len(marks) == res.edges.n_edges  # one line per edge file id


def test_pregraph_path_batches_do_not_change_files(paths, reads_cfg,
                                                   tmp_path, monkeypatch):
    """Threading 700 rows at a time (the port's default is 131,072)
    writes the same .path and .markOnEdge."""
    from soapdenovo_trans_tpu_torch.stages import pregraph as tpg
    monkeypatch.setattr(tpg, "THREAD_ROWS", 700)
    out = str(tmp_path / "small")
    _port_main(["pregraph", "-s", reads_cfg, "-K", "23", "-R", "-o", out])
    _assert_same(paths[1], out, PREGRAPH_FILES + PATH_FILES)


def test_contig_reps_match_jax_cli(paths, tmp_path):
    jax_pg, port_pg, _res = paths
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    _copy_prefix(jax_pg, jax_out)
    _copy_prefix(port_pg, out)
    _jax_main(["contig", "-R", "-g", jax_out])
    (result, _table, _k) = _port_main(["contig", "-R", "-g", out])
    _assert_same(jax_out, out, CONTIG_FILES)
    assert result.reps_split is not None


def _repeat_reads(folder):
    """Two transcripts that share an interior 40-base repeat, A M B and
    C M D: reads over each, written as one single-end library."""
    rng = np.random.default_rng(7)
    a, b, c, d = ("".join(rng.choice(list("ACGT"), size=60))
                  for _ in range(4))
    m = "".join(rng.choice(list("ACGT"), size=40))
    reads = []
    for t in (a + m + b, c + m + d):
        reads += 6 * [t] + [tbits.revcomp_str(t)]
    fa = os.path.join(folder, "reads.fa")
    jfastx.write_fasta(fa, [(f"r{i}", r) for i, r in enumerate(reads)])
    cfg = os.path.join(folder, "lib.config")
    with open(cfg, "w") as fh:
        fh.write(f"max_rd_len=160\n[LIB]\navg_ins=0\nasm_flags=3\nf={fa}\n")
    return cfg, (a + m + b, c + m + d)


def test_repeat_is_split_through_both_clis(tmp_path):
    """``pregraph -R`` + ``contig -R`` on the repeat fixture: the repeat
    edge is split, both transcripts come out whole, and the files match
    the JAX CLI's."""
    cfg, transcripts = _repeat_reads(str(tmp_path))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["-s", cfg, "-K", "23", "-R"]
    _jax_main(["pregraph"] + argv + ["-o", jax_out])
    _port_main(["pregraph"] + argv + ["-o", out])
    _assert_same(jax_out, out, PREGRAPH_FILES + PATH_FILES)
    _jax_main(["contig", "-R", "-g", jax_out])
    (result, _table, _k) = _port_main(["contig", "-R", "-g", out])
    _assert_same(jax_out, out, CONTIG_FILES)
    assert result.reps_split >= 1
    contigs = _read(out + ".contig").decode().replace("\n", "")
    for t in transcripts:
        assert t in contigs or tbits.revcomp_str(t) in contigs
    # without the .path file -R changes nothing: the plain contig stage,
    # in which the repeat still blocks both transcripts
    bare, plain = str(tmp_path / "bare"), str(tmp_path / "plain")
    for prefix in (bare, plain):
        for ext in PREGRAPH_FILES:
            shutil.copy(out + ext, prefix + ext)
    (result, _table, _k) = _port_main(["contig", "-R", "-g", bare])
    _port_main(["contig", "-g", plain])
    assert result.reps_split is None
    _assert_same(plain, bare, CONTIG_FILES)
    contigs = _read(bare + ".contig").decode().replace("\n", "")
    assert not any(t in contigs or tbits.revcomp_str(t) in contigs
                   for t in transcripts)


# --- (d) map -f and the port's batch size ---------------------------------

@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    """(config, port prefix with contig files) of 5,000 pairs: 10,000
    reads are three 4,096-row blocks of the map stage's gap-read
    order.  The contigs are -M 0's: Tour-Bus at -M 1 assembles this
    fixture's transcripts whole, and no read is left for a gap."""
    folder = tmp_path_factory.mktemp("deep")
    cfg = perf_e2e.synth(str(folder), n_tx=30, n_pairs=5000, seed=3)
    out = str(folder / "port")
    _port_main(["pregraph", "-s", cfg, "-K", "23", "-o", out])
    _port_main(["contig", "-g", out, "-M", "0"])
    return cfg, out


def test_map_gap_reads_do_not_depend_on_batch_size(deep, tmp_path,
                                                   monkeypatch):
    cfg, contigs = deep
    argv = ["map", "-s", cfg, "-f", "-r", "-g"]
    jax_out = str(tmp_path / "jax")
    _copy_prefix(contigs, jax_out)
    _jax_main(argv + [jax_out])
    for batch in (tcli.MAP_BATCH, 8192, 256):  # 256 -> one 4,096-row block
        monkeypatch.setattr(tcli, "MAP_BATCH", batch)
        out = str(tmp_path / f"b{batch}")
        _copy_prefix(contigs, out)
        res = _port_main(argv + [out])
        assert res.reads == 10000 and res.gap_reads > 0
        _assert_same(jax_out, out, MAP_FILES + GAP_READ_FILES +
                     (".readInformation",))
    # the records of .readInGap are those of .shortreadInGap.gz
    assert _read(out + ".shortreadInGap.gz").count(b">read_") == \
        res.gap_reads
