"""The whole main path end to end: the port's ``all`` against the JAX
CLI's ``all``, byte for byte, at K = 23 and K = 31 (every stage file;
.scafStatistics with the output prefix replaced, since the report names
its own path); ``map -g`` then ``scaff -g`` resumed from copies of the
contig files against the JAX CLI's; two map batch sizes; every flag use
parsed as the JAX CLI parses it; and ``all -F -f -R`` with jax, the JAX
package and pandas unimportable.  The JAX CLI's Tour-Bus runs under the
port's arc rule (``tests/tourbus_rule.py``), where the port departs from
it."""

import gzip
import os
import shutil
import subprocess
import sys

import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu import cli as jcli
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu_torch import cli as tcli
from tests.tourbus_rule import rule_on

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREGRAPH_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
                  ".edge.gz")
CONTIG_FILES = (".contig", ".ContigIndex", ".updated.edge", ".Arc")
MAP_FILES = (".peGrads", ".readOnContig", ".ctg2Read")
SCAFF_FILES = (".links", ".scaf", ".scaf_gap", ".contigPosInscaff", ".agp",
               ".scafSeq", ".gapSeq")
RESUME_INPUTS = (".preGraphBasic",) + CONTIG_FILES


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=40,
                          n_pairs=2000, seed=1)


@pytest.fixture(scope="module", params=[23, 31])
def jax_all(request, reads_cfg, tmp_path_factory):
    """(K, prefix) of one JAX CLI ``all`` run, shared by the tests."""
    k = request.param
    out = str(tmp_path_factory.mktemp(f"jax_k{k}") / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "CAP_MODE", jd.CAP_MODE)  # cli.main mutates it
        rule_on(mp)  # the port's Tour-Bus arc rule
        jcli.main(["all", "-s", reads_cfg, "-K", str(k), "-o", out])
    return k, out


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _assert_same(want, got, exts):
    for ext in exts:
        assert _read(got + ext) == _read(want + ext), ext


def _assert_same_statistics(want, got):
    """.scafStatistics names '<prefix>.scafSeq' and '<prefix>.contig'."""
    text = [_read(p + ".scafStatistics").decode().replace(p + ".", "P.")
            for p in (want, got)]
    assert text[1] == text[0] and "N50\t" in text[1]


def _copy(src, dst, exts):
    for ext in exts:
        shutil.copy(src + ext, dst + ext)


def test_all_files_match_jax_cli(jax_all, reads_cfg, tmp_path, monkeypatch):
    k, jax_out = jax_all
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    out = str(tmp_path / "port")
    res = tcli.main(["all", "-s", reads_cfg, "-K", str(k), "-o", out])
    _assert_same(jax_out, out, PREGRAPH_FILES + CONTIG_FILES + MAP_FILES +
                 SCAFF_FILES)
    _assert_same_statistics(jax_out, out)
    assert set(res.stage_seconds) == set(res.peak_bytes) == {
        "pregraph", "contig", "map", "scaff"}
    assert 0 < res.map.mapped <= res.map.reads == 4000
    assert res.scaff.connections > 0
    assert any(h.startswith("scaffold") for h, _ in res.scaff.recs)
    assert os.path.getsize(out + ".gapSeq") == 0  # no -F


def test_resumed_map_scaff_match_jax_cli(jax_all, reads_cfg, tmp_path,
                                         monkeypatch):
    """map -g + scaff -g on copies of the JAX run's contig files, the
    loader's .newContigIndex included."""
    k, jax_all_out = jax_all
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(jd, "CAP_MODE", jd.CAP_MODE)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    for prefix in (jax_out, out):
        _copy(jax_all_out, prefix, RESUME_INPUTS)
    for cli in (jcli, tcli):
        prefix = jax_out if cli is jcli else out
        cli.main(["map", "-s", reads_cfg, "-g", prefix])
        cli.main(["scaff", "-g", prefix])
    _assert_same(jax_out, out, (".newContigIndex",) + MAP_FILES +
                 SCAFF_FILES)
    _assert_same_statistics(jax_out, out)
    # the in-memory run agrees up to the links; its scaffolds may not: the
    # contig stage can leave a twin whose sequence is not the reverse
    # complement of the row .contig prints (one pair at K = 31 here)
    _assert_same(jax_all_out, out, MAP_FILES + (".links", ".scaf"))


def test_map_batch_size_keeps_files(jax_all, reads_cfg, tmp_path,
                                    monkeypatch):
    """One batch of all 4,000 reads, and batches of 256 (the last one
    padded): the read numbers and the files stay the same."""
    _k, jax_out = jax_all
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    outs = []
    for batch in (tcli.MAP_BATCH, 256):
        monkeypatch.setattr(tcli, "MAP_BATCH", batch)
        out = str(tmp_path / f"b{batch}")
        _copy(jax_out, out, RESUME_INPUTS)
        res = tcli.main(["map", "-s", reads_cfg, "-g", out])
        assert res.reads == 4000 and res.mapped > 0
        outs.append(out)
    _assert_same(outs[0], outs[1], MAP_FILES)


@pytest.mark.parametrize("argv", [
    ["map", "-s", "c", "-g", "x", "-f"], ["map", "-s", "c", "-g", "x", "-r"],
    ["map", "-s", "c", "-g", "x", "-R"], ["scaff", "-g", "x", "-F"],
    ["scaff", "-g", "x", "-S"], ["scaff", "-g", "x", "-r"],
    ["scaff", "-g", "x", "-R"], ["all", "-s", "c", "-o", "x", "-f"],
    ["all", "-s", "c", "-o", "x", "-F"], ["all", "-s", "c", "-o", "x", "-S"],
    ["all", "-s", "c", "-o", "x", "-r"], ["all", "-s", "c", "-o", "x", "-R"],
    ["pregraph", "-s", "c", "-o", "x", "-R"], ["contig", "-g", "x", "-R"],
    ["scaff", "-g", "x", "-s", "c", "-F", "-G", "30", "-S", "-r", "-R"],
    ["all", "-s", "c", "-o", "x", "-F", "-f", "-S", "-r", "-R", "-G", "9"],
], ids=lambda a: " ".join([a[0]] + [x for x in a if x[0] == "-"
                                     and x not in ("-s", "-g", "-o")]))
def test_cli_parses_flags_like_jax_cli(argv):
    """No flag is refused: each use parses to what the JAX CLI's parser
    gives (``all`` also carries the stage-only defaults)."""
    want = vars(jcli.build_parser().parse_args(argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert {dest: got[dest] for dest in want} == want
    assert not hasattr(tcli, "_refuse_unported")


def test_all_runs_without_jax_or_pandas(tmp_path):
    """Neither jax, nor any module of the JAX package, nor pandas can be
    imported: the port's ``all -F -f -R`` still runs to the end, then
    ``pregraph -R``, ``contig -R`` and ``scaff -S -F -r`` on its files."""
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=300, seed=2)
    out = str(tmp_path / "nojax")
    code = (
        "import sys\n"
        "for name in ('jax', 'soapdenovo_trans_tpu', 'pandas'):\n"
        "    sys.modules[name] = None\n"  # any import of them now fails
        "from soapdenovo_trans_tpu_torch import cli\n"
        f"res = cli.main(['all', '-s', {cfg!r}, '-K', '23', '-o', {out!r},\n"
        "                 '-F', '-f', '-R'])\n"
        "assert res.map.mapped > 0 and res.scaff.recs\n"
        "assert res.map.pe_rows > 0 and 'fill' in res.scaff.phase_seconds\n"
        f"cli.main(['scaff', '-g', {out!r}, '-s', {cfg!r}, '-S', '-F', '-r'])\n"
        f"pg = cli.main(['pregraph', '-s', {cfg!r}, '-o', {out!r}, '-R'])\n"
        "assert pg.path_reads > 0\n"
        f"ctg = cli.main(['contig', '-g', {out!r}, '-R'])[0]\n"
        "assert ctg.reps_split is not None\n"
        "for name in ('jax', 'soapdenovo_trans_tpu', 'pandas'):\n"
        "    assert sys.modules[name] is None\n")
    env = dict(os.environ, SOAPDENOVO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for ext in (".contig",) + MAP_FILES + (
            ".scaf", ".scafSeq", ".scafStatistics", ".readInformation",
            ".PEreadOnContig.gz", ".readOnScaf", ".RPKM.Stat", ".path",
            ".markOnEdge"):
        assert os.path.getsize(out + ext) > 0, ext
    for ext in (".readInGap", ".shortreadInGap.gz", ".gapSeq"):
        assert os.path.exists(out + ext), ext
