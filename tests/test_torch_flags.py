"""The gap-filling, gap-read, read-table and resume options, the port's
CLI against the JAX CLI on the same fixture, files byte for byte
(``.gz`` files after decompression; ``.scafStatistics`` with the output
prefix replaced):

(a) a two-library fixture with a coverage hole that only the mapping
    library spans: ``all -F -f -R`` at K = 23 must fill the hole, then
    ``scaff -F -S`` and ``scaff -F -r`` on copies;
(b) a simulated paired library: ``all -F -f -r`` at K = 23 and 31.

One JAX run per fixture and K, its Tour-Bus under the port's arc rule
(``tests/tourbus_rule.py``).  ``tests/test_torch_flags_paths.py`` holds
``pregraph -R``, ``contig -R`` and ``map -f`` at several batch sizes."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu import cli as jcli
from soapdenovo_trans_tpu.io import fastx as jfastx
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.ops import bits as tbits
from tests.tourbus_rule import rule_on

PREGRAPH_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
                  ".edge.gz")
CONTIG_FILES = (".contig", ".ContigIndex", ".updated.edge", ".Arc")
MAP_FILES = (".peGrads", ".readOnContig", ".ctg2Read")
GAP_READ_FILES = (".readInGap", ".shortreadInGap.gz", ".PEreadOnContig.gz")
SCAFF_FILES = (".links", ".scaf", ".scaf_gap", ".contigPosInscaff", ".agp",
               ".scafSeq", ".gapSeq")
READ_TABLES = (".readInformation", ".readOnScaf")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_main(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "CAP_MODE", jd.CAP_MODE)  # cli.main mutates it
        rule_on(mp)  # the port's Tour-Bus arc rule
        jcli.main(argv)


def _port_main(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
        return tcli.main(argv)


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _assert_same(want, got, exts):
    for ext in exts:
        assert _read(got + ext) == _read(want + ext), ext


def _assert_same_statistics(want, got):
    text = [_read(p + ".scafStatistics").decode().replace(p + ".", "P.")
            for p in (want, got)]
    assert text[1] == text[0] and "N50\t" in text[1]


def _copy_prefix(src, dst):
    folder, name = os.path.split(src)
    for f in os.listdir(folder):
        if f.startswith(name + "."):
            shutil.copy(os.path.join(folder, f), dst + f[len(name):])


# --- (a) the hole fixture -------------------------------------------------

def _hole_fixture(folder):
    """One 700-base transcript; the contig-building library leaves bases
    330..370 uncovered, the mapping-only paired library (insert 200)
    spans them."""
    rng = np.random.default_rng(1234)
    t1 = "".join(rng.choice(list("ACGT"), size=700))
    hole = (330, 370)
    ins, rl = 200, 50
    cov = [t1[i: i + rl] for i in range(0, len(t1) - rl + 1, 2)
           if i + rl <= hole[0] or i >= hole[1]]
    pe = []
    for i in range(0, len(t1) - ins, 4):
        frag = t1[i: i + ins]
        pe.append(frag[:rl])
        pe.append(tbits.revcomp_str(frag[-rl:]))
    c_fa, p_fa = os.path.join(folder, "cov.fa"), os.path.join(folder, "pe.fa")
    jfastx.write_fasta(c_fa, [(f"c{i}", r) for i, r in enumerate(cov)])
    jfastx.write_fasta(p_fa, [(f"p{i}", r) for i, r in enumerate(pe)])
    cfg = os.path.join(folder, "lib.config")
    with open(cfg, "w") as fh:
        fh.write("max_rd_len=50\n"
                 f"[LIB]\navg_ins=0\nasm_flags=1\nf={c_fa}\n"
                 f"[LIB]\navg_ins=200\nasm_flags=2\np={p_fa}\n")
    return cfg, t1


@pytest.fixture(scope="module")
def hole(tmp_path_factory):
    """(config, transcript, JAX prefix, port prefix) after ``all -F -f
    -R -L 100`` at K = 23 through both CLIs."""
    folder = str(tmp_path_factory.mktemp("hole"))
    cfg, t1 = _hole_fixture(folder)
    argv = ["all", "-s", cfg, "-K", "23", "-F", "-f", "-R", "-L", "100"]
    jax_out, out = os.path.join(folder, "jax"), os.path.join(folder, "port")
    _jax_main(argv + ["-o", jax_out])
    res = _port_main(argv + ["-o", out])
    return cfg, t1, jax_out, out, res


def test_all_fill_gap_reads_rpkm_match_jax_cli(hole):
    _cfg, t1, jax_out, out, res = hole
    _assert_same(jax_out, out, PREGRAPH_FILES + CONTIG_FILES + MAP_FILES +
                 GAP_READ_FILES + SCAFF_FILES + READ_TABLES + (".RPKM.Stat",))
    _assert_same_statistics(jax_out, out)
    # the hole is filled: a gap sequence, and the transcript without Ns
    assert os.path.getsize(out + ".gapSeq") > 0
    assert res.scaff.gap_report
    core = t1[5:-5]
    assert any(core in s or core in tbits.revcomp_str(s)
               for _h, s in res.scaff.recs)
    assert res.map.gap_reads > 0 and res.map.pe_rows > 0
    assert {"collect", "fill", "fill_tables", "fill_graph", "fill_bfs",
            "fill_trace"} <= set(res.scaff.phase_seconds)


def test_rpkm_hits_sum_to_placed_reads(hole):
    out = hole[3]
    lines = _read(out + ".RPKM.Stat").decode().splitlines()
    total = int(lines[1].split("=")[1])
    rows = [line.split("\t") for line in lines[3:]]
    assert total == sum(int(r[2]) for r in rows) > 0
    assert all(len(r[3].split(".")[1]) == 6 for r in rows)  # "%f"


def test_scaff_resume_with_fill_matches_jax_cli(hole, tmp_path):
    """``scaff -g -s cfg -F -L 100 -S`` on copies of each CLI's files:
    the transcripts come from .scaf_gap, the gap is filled again."""
    cfg, _t1, jax_all, port_all, _res = hole
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    _copy_prefix(jax_all, jax_out)
    _copy_prefix(port_all, out)
    argv = ["scaff", "-s", cfg, "-F", "-L", "100", "-S", "-g"]
    _jax_main(argv + [jax_out])
    res = _port_main(argv + [out])
    _assert_same(jax_out, out, SCAFF_FILES)
    _assert_same_statistics(jax_out, out)
    assert _read(out + ".scafSeq") == _read(port_all + ".scafSeq")
    assert res.gap_report and os.path.getsize(out + ".gapSeq") > 0


def test_scaff_fill_without_config_matches_jax_cli(hole, tmp_path):
    """-F without -s: no reads to recruit, so only arc routes and flank
    overlaps can close a gap; -r without -R writes no .RPKM.Stat."""
    _cfg, _t1, jax_all, port_all, _res = hole
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    _copy_prefix(jax_all, jax_out)
    _copy_prefix(port_all, out)
    for prefix in (jax_out, out):
        os.remove(prefix + ".RPKM.Stat")
    argv = ["scaff", "-F", "-r", "-L", "100", "-G", "20", "-g"]
    _jax_main(argv + [jax_out])
    _port_main(argv + [out])
    _assert_same(jax_out, out, SCAFF_FILES + (".readOnScaf",))
    assert not os.path.exists(out + ".RPKM.Stat")


# --- (b) a simulated paired library ---------------------------------------

@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=40,
                          n_pairs=2000, seed=1)


@pytest.mark.parametrize("k", [23, 31])
def test_all_fill_gap_reads_trace_match_jax_cli(k, reads_cfg, tmp_path):
    argv = ["all", "-s", reads_cfg, "-K", str(k), "-F", "-f", "-r"]
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_main(argv + ["-o", jax_out])
    res = _port_main(argv + ["-o", out])
    _assert_same(jax_out, out, PREGRAPH_FILES + CONTIG_FILES + MAP_FILES +
                 GAP_READ_FILES + SCAFF_FILES + READ_TABLES)
    _assert_same_statistics(jax_out, out)
    assert not os.path.exists(out + ".RPKM.Stat")  # -r, not -R
    assert res.map.pe_rows > 0
