"""The slice end to end: ``pregraph`` of the PyTorch port against the
JAX CLI, byte for byte, on a multi-unit fixture; plus the port running
with jax made unimportable."""

import gzip
import os
import subprocess
import sys

import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu import cli as jcli
from soapdenovo_trans_tpu.ops import dictionary as jd
from soapdenovo_trans_tpu.stages import pregraph as jpg
from soapdenovo_trans_tpu_torch import cli as tcli
from soapdenovo_trans_tpu_torch.ops import dictionary as td
from soapdenovo_trans_tpu_torch.stages import pregraph as tpg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGE_FILES = (".kmerFreq", ".vertex", ".preArc", ".preGraphBasic",
               ".peGrads", ".edge.gz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads_cfg(tmp_path_factory):
    # 16,000 reads: four 4096-read build units once the unit target is low
    return perf_e2e.synth(str(tmp_path_factory.mktemp("reads")), n_tx=40,
                          n_pairs=8000, seed=1)


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("k", [23, 31])  # merge kernel path / 3-lane sort
def test_pregraph_files_match_jax_cli(k, reads_cfg, tmp_path, monkeypatch):
    monkeypatch.setattr(jd, "CAP_MODE", jd.CAP_MODE)  # cli.main mutates it
    monkeypatch.setattr(jpg, "TARGET_BUILD_ROWS", 1)
    monkeypatch.setattr(tpg, "TARGET_BUILD_ROWS", 1)
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cpu")
    merges = []
    merge_runs = td.merge_runs
    monkeypatch.setattr(td, "merge_runs",
                        lambda a, b: merges.append(1) or merge_runs(a, b))

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jcli.main(["pregraph", "-s", reads_cfg, "-K", str(k), "-o", jax_out])
    res = tcli.main(["pregraph", "-s", reads_cfg, "-K", str(k), "-o",
                     port_out])
    assert len(merges) >= 3
    assert res.edges.n_edges > 0 and res.arcs.n > 0
    for ext in STAGE_FILES:
        assert _read(port_out + ext) == _read(jax_out + ext), ext


def test_cli_refuses_unported_and_missing_device(monkeypatch, tmp_path):
    """No flag is left to refuse (each of these was, once): they parse.
    A CUDA device that torch does not see is still an error, never a
    silent fallback to the CPU."""
    for argv in (["map", "-s", "c", "-o", "x", "-f"],
                 ["scaff", "-g", "x", "-F"],
                 ["all", "-s", "c", "-o", "x", "-R"],
                 ["pregraph", "-s", "c", "-o", "x", "-R"],
                 ["contig", "-g", "x", "-R"]):
        tcli.build_parser().parse_args(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("SOAPDENOVO_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.device_from_env()


def test_port_runs_without_jax(tmp_path):
    """Neither jax nor any module of the JAX package can be imported:
    the port's pregraph still runs to the end."""
    cfg = perf_e2e.synth(str(tmp_path), n_tx=10, n_pairs=300, seed=2)
    out = str(tmp_path / "nojax")
    code = (
        "import sys\n"
        "for name in ('jax', 'soapdenovo_trans_tpu'):\n"
        "    sys.modules[name] = None\n"  # any import of them now fails
        "from soapdenovo_trans_tpu_torch import cli\n"
        f"cli.main(['pregraph', '-s', {cfg!r}, '-K', '23', '-o', {out!r}])\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['soapdenovo_trans_tpu'] is None\n")
    env = dict(os.environ, SOAPDENOVO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    for ext in STAGE_FILES:
        assert os.path.getsize(out + ext) > 0, ext
