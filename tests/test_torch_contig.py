"""The contig stage end to end: the port's ``contig -g`` against the JAX
CLI's on the same pregraph files, byte for byte (K = 23 and K = 31);
the in-memory path after pregraph (as ``all`` runs it) against the JAX
package's; and the port's pregraph + contig with jax made
unimportable.  The JAX package's Tour-Bus runs under the port's arc
rule (``tests/tourbus_rule.py``), where the port departs from it."""

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
PREGRAPH_FILES = (".preGraphBasic", ".vertex", ".edge.gz", ".preArc")
CONTIG_FILES = (".contig", ".ContigIndex", ".updated.edge", ".Arc")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=40,
                          n_pairs=2000, seed=1)


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _copy_pregraph(src, dst):
    for ext in PREGRAPH_FILES:
        shutil.copy(src + ext, dst + ext)


def _assert_same(jax_out, port_out, result):
    """Every contig file equal and holding records; ``.Arc`` may be empty
    where the port's contigs have no arc between them (at -M 1 Tour-Bus
    can leave none on this fixture)."""
    arcs = result.contigs.arcs
    joined = int(((arcs.from_ed[:arcs.n] >= 0)
                  & (arcs.to_ed[:arcs.n] >= 0)).sum())
    for ext in CONTIG_FILES:
        want = _read(jax_out + ext)
        assert len(want) > 0 or (ext == ".Arc" and joined == 0), ext
        assert _read(port_out + ext) == want, ext


@pytest.mark.parametrize("k", [23, 31])
def test_contig_files_match_jax_cli(k, reads_cfg, tmp_path, monkeypatch):
    monkeypatch.setattr(jd, "CAP_MODE", jd.CAP_MODE)  # cli.main mutates it
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    pre = str(tmp_path / "pre")
    tcli.main(["pregraph", "-s", reads_cfg, "-K", str(k), "-o", pre])
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    _copy_pregraph(pre, jax_out)
    _copy_pregraph(pre, port_out)
    rule_on(monkeypatch)  # the port's Tour-Bus arc rule
    jcli.main(["contig", "-g", jax_out])
    result, _table, got_k = tcli.main(["contig", "-g", port_out])
    assert got_k == k and result.contigs.n > 0
    assert result.tourbus["merged"] > 0 and result.tourbus["waves"] > 1
    assert set(result.phase_seconds) == {"bubbles", "clean", "laps", "short"}
    _assert_same(jax_out, port_out, result)


def test_in_memory_contig_matches_jax(reads_cfg, tmp_path, monkeypatch):
    """run_contig_cmd on the pregraph result, as ``all`` runs it."""
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    rule_on(monkeypatch)  # the port's Tour-Bus arc rule
    jargs = jcli.build_parser().parse_args(
        ["all", "-s", reads_cfg, "-K", "23", "-o", jax_out])
    jcli.run_contig_cmd(jargs, jcli.run_pregraph_cmd(jargs))
    dev = torch.device("cpu")
    res = tcli.run_pregraph_cmd(tcli.build_parser().parse_args(
        ["pregraph", "-s", reads_cfg, "-K", "23", "-o", port_out]), dev)
    result, table, k = tcli.run_contig_cmd(
        tcli.build_parser().parse_args(["contig", "-g", port_out]), dev, res)
    assert k == 23 and table is res.table
    _assert_same(jax_out, port_out, result)


def test_contig_runs_without_jax(tmp_path):
    """Neither jax nor any module of the JAX package can be imported:
    the port's pregraph and then contig -g still run to the end."""
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=300, seed=2)
    out = str(tmp_path / "nojax")
    code = (
        "import sys\n"
        "for name in ('jax', 'soapdenovo_trans_tpu'):\n"
        "    sys.modules[name] = None\n"  # any import of them now fails
        "from soapdenovo_trans_tpu_torch import cli\n"
        f"cli.main(['pregraph', '-s', {cfg!r}, '-K', '23', '-o', {out!r}])\n"
        f"cli.main(['contig', '-g', {out!r}])\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['soapdenovo_trans_tpu'] is None\n")
    env = dict(os.environ, SOAPDENOVO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for ext in CONTIG_FILES[:3]:  # .Arc is empty: no arc joins two contigs
        assert os.path.getsize(out + ext) > 0, ext
    assert os.path.exists(out + ".Arc")
