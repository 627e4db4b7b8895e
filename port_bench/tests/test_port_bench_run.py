"""A run's path on the CPU at a small size: the result line, no JAX in
the process, and ``correct`` false under each fault the cells can have.
A run with no card fails and prints no result."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from port_bench import run

CELL = "pe100_k23_m0.uniform"
PAIRS = 2500


@pytest.fixture()
def env(monkeypatch):
    # run_cell sets these; monkeypatch puts them back afterwards
    for key in ("SOAPDENOVO_TORCH_DEVICE", "SOAPDENOVO_TORCH_NO_SHARD"):
        monkeypatch.setenv(key, "")
    return monkeypatch


def _run(tmp_path, trace=False, seed=2**31 + 5):
    return run.run_cell(CELL, seed, 0.5, trace, device_name="cpu",
                        pairs=PAIRS, warmup_pairs=300, transcripts=25,
                        workroot=str(tmp_path))


def test_a_run_with_no_card_fails_and_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(
        [sys.executable, os.path.join(run.ROOT, "port_bench", "run.py"),
         "--workload", CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=run.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_result_line_on_the_cpu(env, tmp_path):
    out = _run(tmp_path)
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "assembly_s",
                                   "peak_device_bytes"}
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert not run.forbidden_modules()
    assert os.listdir(tmp_path) == []


def test_traced_result_line_on_the_cpu(env, tmp_path):
    out = _run(tmp_path, trace=True)
    assert out["correct"] is True
    assert {"pregraph_s", "pregraph.count_s", "map_s"} <= set(out["metrics"])
    assert "busy_s" in out["device"] and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # restored after the trace
    from soapdenovo_trans_tpu_torch import cli
    assert cli.run_pregraph_cmd.__name__ == "run_pregraph_cmd"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "soapdenovo_trans_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_the_port_loads_no_jax(tmp_path):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {run.ROOT!r})\n"
        "from port_bench import run\n"
        f"out = run.run_cell({CELL!r}, 9, 0.1, False, device_name='cpu', "
        f"pairs=600, warmup_pairs=200, workroot={str(tmp_path)!r})\n"
        "print(json.dumps([out['correct'], run.forbidden_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules})]))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path),
                       env={**os.environ, "SOAPDENOVO_TORCH_DEVICE": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    correct, found, tops = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and found == []
    assert "soapdenovo_trans_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "soapdenovo_trans_tpu"} & set(tops)


def _half_of_each_batch(real):
    def batches(*args, **kwargs):
        for codes, lens, li in real(*args, **kwargs):
            lens = lens.copy()
            lens[1::2] = 0
            yield codes, lens, li
    return batches


def _altered_contig(real):
    def seqs(*args, **kwargs):
        out = list(real(*args, **kwargs))
        for r in range(0, len(out), 10):  # a base of every tenth row
            s = out[r]
            i = len(s) // 2
            out[r] = s[:i] + {"A": "C", "C": "G", "G": "T", "T": "A"}[
                s[i]] + s[i + 1:]
        return out
    return seqs


def _unchanged_arcs(real):
    def thread(*args, **kwargs):
        f, t, v = real(*args, **kwargs)
        return f, t, v & False
    return thread


@pytest.mark.parametrize("target,fault", [
    ("soapdenovo_trans_tpu_torch.io.fastx.config_read_batches",
     _half_of_each_batch),
    ("soapdenovo_trans_tpu_torch.graph.contig_merge.contig_sequences",
     _altered_contig),
    ("soapdenovo_trans_tpu_torch.graph.arcs.thread_reads",
     _unchanged_arcs),
], ids=["half_of_the_batch_left_out", "an_answer_altered",
        "threading_leaves_the_arcs_unchanged"])
def test_a_broken_timed_path_is_not_correct(env, tmp_path, target, fault):
    import importlib

    mod_name, attr = target.rsplit(".", 1)
    mod = importlib.import_module(mod_name)
    env.setattr(mod, attr, fault(getattr(mod, attr)))
    out = _run(tmp_path)
    assert out["correct"] is False and out["failed"] == 1
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("drop", ["drop_edges", "drop_contigs",
                                  "drop_placements", "drop_transcripts"])
def test_output_left_out_is_not_correct(env, tmp_path, drop):
    """Each assembly's files lose every tenth edge, contig, placement or
    transcript as the timed path writes them."""
    from port_bench import control

    real = run.Assembler.run

    def lossy(self):
        res = real(self)
        getattr(control, drop)(self.prefix, None, None, None)
        return res
    env.setattr(run.Assembler, "run", lossy)
    out = _run(tmp_path)
    assert out["correct"] is False and out["failed"] == 1
    number = control.DROPS[drop]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.fixture()
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.gpu
def test_a_short_run_on_the_card(card, tmp_path):
    p = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELL,
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=run.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert np.isfinite(out["metrics"]["assembly_s"]["value"])
