"""The Tour-Bus pinch on the card, its waves replayed from a CUDA graph
(``graph/tourbus.WaveProgram``), against the same pinch on the CPU.
Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest tests/test_torch_tourbus_gpu.py -m gpu

The graph is the port's pregraph of ``perf_e2e.synth`` reads (20,000
pairs, seed 0, built on the CPU): 12 waves at -M 1 and 11 at -M 3 with
the pinch's 1,024 candidates a wave; the pinch test takes 256 a wave,
125 and 42 waves, so that most of them are replays.  Exact comparison
(tolerance 0)."""

import os

import pytest
import torch

import perf_e2e
from soapdenovo_trans_tpu_torch import cli
from soapdenovo_trans_tpu_torch.graph import tourbus
from soapdenovo_trans_tpu_torch.io import graph_files
from soapdenovo_trans_tpu_torch.kernels import lcs

PAIRS = 20_000


def _to(nt, dev):
    return type(nt)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                      for x in nt))


@pytest.fixture(scope="module")
def pregraph(tmp_path_factory):
    """(EdgeGraph, ArcSet, k) of the pregraph stage, on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wave program replays a CUDA "
                    "graph")
    folder = str(tmp_path_factory.mktemp("tourbus_gpu"))
    cfg = perf_e2e.synth(folder, n_tx=PAIRS // 100, n_pairs=PAIRS, seed=0)
    prefix = os.path.join(folder, "asm")
    saved = os.environ.get("SOAPDENOVO_TORCH_DEVICE")
    os.environ["SOAPDENOVO_TORCH_DEVICE"] = "cpu"
    try:
        cli.main(["pregraph", "-s", cfg, "-K", "23", "-o", prefix])
    finally:
        if saved is None:
            del os.environ["SOAPDENOVO_TORCH_DEVICE"]
        else:
            os.environ["SOAPDENOVO_TORCH_DEVICE"] = saved
    _table, eg, aset, k = graph_files.load_pregraph_files(
        prefix, torch.device("cpu"))
    return eg, aset, k


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 3])
def test_replayed_pinch_equals_cpu(pregraph, level, monkeypatch):
    """The card's pinch (one eager wave, one capture, replays) gives the
    CPU pinch's graph, table and counters; one capture, every later wave
    a replay, and one identity kernel execution a wave."""
    monkeypatch.setattr(tourbus, "CAND_CAP", 256)
    eg, aset, k = pregraph
    ceg, cas, cst = tourbus.pinch(eg, aset, k, level)
    tourbus.CAPTURES = tourbus.REPLAYS = lcs.IDENTITY_LAUNCHES = 0
    dev = torch.device("cuda")
    geg, gas, gst = tourbus.pinch(_to(eg, dev), _to(aset, dev), k, level)
    torch.cuda.synchronize()
    for key in ("backtracked", "compared", "merged", "waves", "productive",
                "arcs_dropped"):
        assert gst[key] == cst[key], key
    assert gst["waves"] >= 20 and 1 <= gst["productive"]
    assert tourbus.CAPTURES == 1
    assert tourbus.REPLAYS == gst["waves"] - 1
    assert lcs.IDENTITY_LAUNCHES == gst["waves"]
    for name in ("cvg", "deleted"):
        torch.testing.assert_close(getattr(geg, name).cpu(),
                                   getattr(ceg, name), rtol=0, atol=0)
    assert gas.n == cas.n == gas.from_ed.shape[0]
    for field in ("from_ed", "to_ed", "mult"):
        torch.testing.assert_close(getattr(gas, field).cpu(),
                                   getattr(cas, field), rtol=0, atol=0)


@pytest.mark.gpu
def test_replay_syncs_nothing(pregraph):
    """A replayed wave, with any host synchronisation an error, raises
    nothing; its counts equal the CPU program's wave for wave."""
    eg, aset, k = pregraph
    m_max, diff = tourbus._params_for(1)
    dev = torch.device("cuda")
    progs = [tourbus.WaveProgram(eg, aset, m_max, diff),
             tourbus.WaveProgram(_to(eg, dev), _to(aset, dev), m_max, diff)]
    for wave in range(4):
        if wave < 3:
            counts = [p.launch().tolist() for p in progs]
        else:
            want = progs[0].launch().tolist()
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = progs[1].launch()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            counts = [want, got.tolist()]
        assert counts[0] == counts[1]
        if counts[0][0]:
            for p in progs:
                p.apply()
    assert progs[1].graph is not None and progs[0].graph is None
